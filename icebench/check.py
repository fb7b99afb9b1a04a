"""The reference's side of a run: the reference that the cell's
configuration names (`catalog.reference`) stepped, in float64 and in
float32, from the benchmark's initial state through the
set-up's steps, and from the program's state before the check step after
the window through that step; and the gaps of the program's states to it
(`reference/compare.py`). It runs after the window has closed, the peak
memory has been read and the program has been freed."""

from __future__ import annotations

import gc
import math

import torch

from .leaves import fill, leaves, to_host
from .reference.compare import leaf_gaps, worst


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def gaps(reference, run: dict, device, initial: dict, warm: int,
         start: dict, pre: dict, n_pre: int, post: dict, log=print) -> dict:
    """{"start_gap": (gap, leaf), "window_gap": (gap, leaf)}.

    `reference` is the configuration's `ReferenceModel` class; `initial`
    the benchmark's initial state, `start` the program's state after
    `warm` steps from it; `pre` the program's state after `n_pre` steps
    and `post` after one step more. A leaf that reads inf is logged with
    whose fault it is: the program's, or the reference's in float32 or
    float64 (`compare.leaf_gaps` reads inf for either)."""
    ref = {}
    for dtype in ("float64", "float32"):
        m = reference(run, device, dtype)
        z = m.zeros()
        st, cal = fill(z, initial), m.calendar(0)
        for _ in range(warm):
            st, cal = m.step(st, cal)
        ref[dtype, "start"] = to_host(leaves(st))
        st, _ = m.step(fill(z, pre), m.calendar(n_pre))
        ref[dtype, "window"] = to_host(leaves(st))
        del m, z, st
        _free(device)
    out = {}
    for name, prog in (("start", start), ("window", post)):
        r32, r64 = ref["float32", name], ref["float64", name]
        g = leaf_gaps(prog, r32, r64, device=device)
        out[f"{name}_gap"] = worst(g)
        for k, v in g.items():
            if math.isfinite(v):
                continue
            refs = [f"the {p} reference holds {n} non-finite values"
                    for p, n in (("float32", _nonfinite(r32[k])),
                                 ("float64", _nonfinite(r64[k]))) if n]
            if refs:
                log(f"{name}: leaf {k} reads inf, the reference's fault: "
                    + ", ".join(refs))
            else:
                n = _nonfinite(prog.get(k))
                log(f"{name}: leaf {k} reads inf: the program's state "
                    + ("lacks it" if n is None
                       else f"holds {n} non-finite values"))
    return out


def _nonfinite(t):
    """The count of non-finite values in `t`; None if there is no `t`."""
    if t is None:
        return None
    if not t.is_floating_point():
        return 0
    return int((~torch.isfinite(t)).sum())
