"""Carry grids, states and forcing between NumPy and the port's dataclasses.

The tests extract numpy dicts from the JAX package's `Grid`, `State`,
`Forcing` and `DynPrep` pytrees (one entry per dataclass field) and turn
them into the port's tensors here, so both implementations see identical
inputs; `*_to_numpy` goes back the other way.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.grid import GRID_FIELDS, BC, Grid, grid_from_arrays
from .dynamics.common import DYNPREP_FIELDS, DynPrep
from .model.flux import FORCING_FIELDS, Forcing
from .model.state import STATE_PLANES, State


def _t(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.as_tensor(a.copy(), device=device)
    return torch.as_tensor(a.copy(), dtype=dtype, device=device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def grid_from_numpy(d: dict, bc: BC, device="cuda", dtype=None) -> Grid:
    """Grid from {field: (ny, nx) array}; dtype defaults to the arrays'."""
    if dtype is None:
        dtype = _t(d["hm"], "cpu").dtype
    return grid_from_arrays(d, bc, dtype, device)


def grid_to_numpy(grid: Grid) -> dict:
    return {k: _np(getattr(grid, k)) for k in GRID_FIELDS}


def state_from_numpy(d: dict, device="cuda") -> State:
    """State from {field: array} with 'trcrn' a {name: array} dict."""
    kw = {k: _t(d[k], device) for k in ("aicen", "vicen", "vsnon")}
    kw.update({k: _t(d[k], device) for k in STATE_PLANES})
    kw["trcrn"] = {k: _t(v, device) for k, v in d["trcrn"].items()}
    return State(**kw)


def state_to_numpy(state: State) -> dict:
    d = {k: _np(getattr(state, k)) for k in ("aicen", "vicen", "vsnon")}
    d.update({k: _np(getattr(state, k)) for k in STATE_PLANES})
    d["trcrn"] = {k: _np(v) for k, v in state.trcrn.items()}
    return d


def forcing_from_numpy(d: dict, device="cuda") -> Forcing:
    return Forcing(**{k: _t(d[k], device) for k in FORCING_FIELDS})


def forcing_to_numpy(fc: Forcing) -> dict:
    return {k: _np(getattr(fc, k)) for k in FORCING_FIELDS}


def dynprep_from_numpy(d: dict, device="cuda") -> DynPrep:
    return DynPrep(**{k: _t(d[k], device) for k in DYNPREP_FIELDS})


def dynprep_to_numpy(prep: DynPrep) -> dict:
    return {k: _np(getattr(prep, k)) for k in DYNPREP_FIELDS}
