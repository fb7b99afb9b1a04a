"""Device ms per step of the horizontal transport of the z-tracer cell
(`model_step`'s phase transport: NT 266, K2 in 19 tracer chunks)."""

from icebench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "transport")
