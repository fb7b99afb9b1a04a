"""Host ms per step in the program's own "History" timer (history
accumulation, files when due, diagnostics every diagfreq steps), over the
untraced steps."""


def read(ctx):
    return ctx.host_ms.get("History")
