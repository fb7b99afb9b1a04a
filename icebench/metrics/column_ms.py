"""Device ms per step of the column physics (`model_step`'s phases
therm1, therm2, fsd and ocean: vertical thermodynamics and shortwave, the
thickness distribution, floe sizes, the slab ocean)."""

from icebench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "therm1", "therm2", "fsd", "ocean")
