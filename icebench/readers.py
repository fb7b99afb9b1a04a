"""What the per-layer readers in `metrics/` share."""


def phase_ms(ctx, *names):
    """Device ms per step of the phases `names` of `model_step`, by the
    benchmark's CUDA-event timer over the window's untraced steps; None
    where none of them ran (an untraced run times no phase)."""
    if not ctx.phases:
        return None
    got = [ctx.phases[n] for n in names if n in ctx.phases]
    return sum(got) if got else None


def per_pass_share(ctx, bound_ms, span: str, *kernel):
    """A kernel's share of its roofline, in %: `bound_ms` (the least ms of
    one pass) over the traced device ms per pass, a pass being one host
    range `span`; None where the trace holds no such kernel."""
    tr = ctx.trace
    if tr is None or not tr.spans.get(span):
        return None
    s = tr.seconds_of(*kernel)
    if s <= 0:
        return None
    return 100.0 * bound_ms / (s * 1e3 / tr.spans[span])
