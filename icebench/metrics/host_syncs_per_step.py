"""Blocking reads of the device per traced step: the program's ranges
"sync:<site>" (each a Picard, rebin or ridging exit, a diagnostics or probe
read, or the step's closing synchronize) in the traced window over the
traced steps; None where the trace holds no such range."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.steps:
        return None
    n = sum(c for name, c in tr.spans.items() if name.startswith("sync:"))
    return n / tr.steps if n else None
