"""Device-idle ms per traced step that follows a blocking read: the idle
gaps whose innermost open host range, at the gap's start, is one of the
program's "sync:<site>" ranges (the read drained the queue, and the host
has not yet refilled it), over the traced steps; None where the trace holds
no such range."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.steps or \
            not any(name.startswith("sync:") for name in tr.spans):
        return None
    idle = sum(s for s, label in tr.gaps if label.startswith("sync:"))
    return idle / tr.steps * 1e3
