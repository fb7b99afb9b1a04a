"""90th percentile (nearest rank) of the host ms of the window's untraced
steps, each from its call to its return after the step's synchronize: the
steps that carry extra ridging or Picard passes and the diagnostics every
24 steps."""

import math


def read(ctx):
    t = sorted(ctx.step_s[i] for i in ctx.quiet)
    return t[math.ceil(0.90 * len(t)) - 1] * 1e3 if t else None
