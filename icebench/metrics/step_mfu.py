"""The whole step's share of one H100's published peaks, in %: the least
ms of the step's work (`yardstick.step_least_ms`: the EVP solves as K1
counts them, the transports as K2 counts them, the state read and written
once) over the mean host ms of the window's untraced steps."""


def read(ctx):
    t = [ctx.step_s[i] for i in ctx.quiet]
    if not t:
        return None
    return 100.0 * ctx.least_step_ms / (sum(t) / len(t) * 1e3)
