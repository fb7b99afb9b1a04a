"""The comparison that decides `correct`.

A state of the program is held against the reference stepped from the
same state in float64 (`r64`) and in the configuration's float32 (`r32`).
For each leaf the gap is ||p - r64|| (2-norm over the leaf) in units of the
reference's own float32 rounding envelope ||r32 - r64||, floored at 2**-24
||r64|| (a leaf that float32 and float64 give alike to the last bits); a
leaf that is zero in all three reads 0. The number compared is the worst
leaf's gap. The program computes in float32, so a sound run reads about 1
in every leaf, however noisy the leaf is (melt-pond residue, melt-onset
flags that flip at a threshold): the envelope of the noisy leaves is wide.
Any non-finite value in the program's state reads inf, and so does any
in either reference: a reference that is not finite judges nothing (an
inf in r32 would widen the envelope to inf and read every program 0).
"""

from __future__ import annotations

import math

import torch

FLOOR = 2.0 ** -24


def leaf_gaps(p: dict, r32: dict, r64: dict, device="cpu") -> dict:
    """{leaf: gap} over the reference's leaves, computed on `device`; a
    leaf the program lacks, or that holds a non-finite value in the
    program or in either reference, reads inf."""
    out = {}
    for k, b in r64.items():
        if k not in p:
            out[k] = math.inf
            continue
        a = p[k].to(device=device, dtype=torch.float64)
        b = b.to(device=a.device, dtype=torch.float64)
        c = r32[k].to(device=a.device, dtype=torch.float64)
        if not all(bool(torch.isfinite(x).all()) for x in (a, b, c)):
            out[k] = math.inf
            continue
        d = float(torch.linalg.vector_norm(a - b))
        den = max(float(torch.linalg.vector_norm(c - b)),
                  FLOOR * float(torch.linalg.vector_norm(b)))
        out[k] = (d / den) if den > 0 else (0.0 if d == 0 else math.inf)
    return out


def worst(gaps: dict) -> tuple:
    """(gap, leaf) of the worst leaf."""
    k = max(gaps, key=lambda n: gaps[n])
    return gaps[k], k
