"""Seconds from the process's start to the first timed step: imports,
kernel load (and, on a checkout's first run, build), inputs, the model,
the warm steps."""


def read(ctx):
    return ctx.setup_s
