"""Host ms per step in the program's own "Forcing" timer (record reads,
interpolation, preparation enqueued), over the untraced steps."""


def read(ctx):
    return ctx.host_ms.get("Forcing")
