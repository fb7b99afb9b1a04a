"""Kernel launches in the traced window per traced step."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.steps:
        return None
    return tr.launches / tr.steps
