"""The reference's side of a run: the frozen plain path stepped, in
float64 and in float32, from the benchmark's initial state through the
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
from .reference.model import ReferenceModel


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def gaps(run: dict, device, initial: dict, warm: int, start: dict,
         pre: dict, n_pre: int, post: dict, log=print) -> dict:
    """{"start_gap": (gap, leaf), "window_gap": (gap, leaf)}.

    `initial` is the benchmark's initial state, `start` the program's
    state after `warm` steps from it; `pre` the program's state after
    `n_pre` steps and `post` after one step more."""
    ref = {}
    for dtype in ("float64", "float32"):
        m = ReferenceModel(run, device, dtype)
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
            if not math.isfinite(v):
                log(f"{name}: leaf {k} non-finite values: program "
                    f"{_nonfinite(prog.get(k))}, float32 reference "
                    f"{_nonfinite(r32[k])}, float64 reference "
                    f"{_nonfinite(r64[k])}")
    return out


def _nonfinite(t) -> str:
    if t is None:
        return "missing"
    if not t.is_floating_point():
        return "0"
    return str(int((~torch.isfinite(t)).sum()))
