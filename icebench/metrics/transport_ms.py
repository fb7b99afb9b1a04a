"""Device ms per step of the horizontal transport (`model_step`'s phase
transport)."""

from icebench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "transport")
