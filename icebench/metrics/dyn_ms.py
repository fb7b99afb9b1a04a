"""Device ms per step of the dynamics (`model_step`'s phase dyn: the EVP
solve and its preparation)."""

from icebench.readers import phase_ms


def read(ctx):
    return phase_ms(ctx, "dyn")
