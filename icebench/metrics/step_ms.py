"""Mean ms per coupled step: the window's wall time over the steps
completed in it, every step ending in its synchronize."""


def read(ctx):
    return ctx.window_s / ctx.steps * 1e3
