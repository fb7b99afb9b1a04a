"""The seeded initial ice state: CICE's default initial state (ice
poleward of 60 degrees over the ocean, a parabolic thickness distribution,
linear temperature profiles; the `default_state` of the configuration's
reference) with a seeded ice thickness and snow depth.

Per cell, from smooth seeded fields u in [0, 1]: each category's ice
volume times (1 + `thick` * (2 u_h - 1)) and its snow volume times (1 +
`snow` * (2 u_s - 1)). The ice edge, the concentrations and every tracer
stay the default state's, so every seed steps the same cells.

params: {"kind": "seeded_caps", "thick": float, "snow": float}
"""

from __future__ import annotations

import torch

from . import smooth
from ..leaves import fill, leaves


def make_state(ref, params: dict, seed: int):
    """The initial state of the reference model `ref` (a `ReferenceModel`
    of the configuration's reference), in its dtype and on its device."""
    g = ref.grid
    st = leaves(ref.default_state())
    u = smooth.field(smooth.rng(seed, "seeded_caps"), g.shape, count=2)
    dt, dev = st["aicen"].dtype, st["aicen"].device
    t = lambda a: torch.as_tensor(a, device=dev).to(dt)
    fh = t(1.0 + float(params["thick"]) * (2.0 * u[0] - 1.0))
    fs = t(1.0 + float(params["snow"]) * (2.0 * u[1] - 1.0))
    st["vicen"] = st["vicen"] * fh
    st["vsnon"] = st["vsnon"] * fs
    return fill(ref.zeros(), st)
