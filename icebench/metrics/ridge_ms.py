"""Device ms per step of ridging (`model_step`'s phase ridge)."""

from icebench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "ridge")
