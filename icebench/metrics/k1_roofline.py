"""K1's share of its roofline, in %: the least ms of one EVP solve on one
H100 (`yardstick.k1_bytes_flops`, operations-bound) over the traced
device ms of K1's kernels (either route) per solve, one solve per "dyn"
phase."""

from icebench import yardstick
from icebench.readers import per_pass_share


def read(ctx):
    s = ctx.shape
    bound = yardstick.bound_ms(*yardstick.k1_bytes_flops(
        s["ny"], s["nx"], s["ndte"]))
    return per_pass_share(ctx, bound, "phase:dyn", "evp_persistent_kernel",
                          "evp_stream_")
