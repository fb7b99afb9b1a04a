"""Device ms per step of the z-tracer biogeochemistry: the brine height
and the vertical z-tracer solve (`model_step`'s phase zbgc, inside
therm1)."""

from icebench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "zbgc")
