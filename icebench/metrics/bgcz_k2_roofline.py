"""K2's share of its roofline in the z-tracer cell, in %: the least ms of
one transport pass on one H100 at the cell's NT
(`yardstick.k2_bytes_flops`, bytes-bound) over the traced device ms of K2
per pass, one pass per "transport" phase."""

from icebench import yardstick
from icebench.readers import per_pass_share


def read(ctx):
    s = ctx.shape
    bound = yardstick.bound_ms(*yardstick.k2_bytes_flops(
        s["nt"], s["ncat"], s["ny"], s["nx"]))
    return per_pass_share(ctx, bound, "phase:transport", "transport_kernel")
