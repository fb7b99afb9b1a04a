"""Carry grids, states and forcing between NumPy and the port's dataclasses.

The tests extract numpy dicts from the JAX package's `Grid`, `State`,
`Forcing` and `DynPrep` pytrees (one entry per dataclass field) and turn
them into the port's tensors here, so both implementations see identical
inputs; `*_to_numpy` goes back the other way. `tree_to_numpy` flattens any
nest of dicts, lists, named tuples and tensors (a `FluxOut`'s dicts,
`step_therm1`'s `agg`) to {dotted key: array} for key-by-key comparison.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.grid import GRID_FIELDS, BC, Grid, grid_from_arrays
from .dynamics.common import DYNPREP_FIELDS, DynPrep
from .model.flux import FLUXOUT_FIELDS, FORCING_FIELDS, FluxOut, Forcing
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


def fluxout_from_numpy(d: dict, device="cuda") -> FluxOut:
    """FluxOut from {field: array} with 'ncat_fluxes' and
    'transport_checks' {name: array} dicts."""
    kw = {k: _t(d[k], device) for k in FLUXOUT_FIELDS}
    for name in ("ncat_fluxes", "transport_checks"):
        kw[name] = {k: _t(v, device) for k, v in d.get(name, {}).items()}
    return FluxOut(**kw)


def fluxout_to_numpy(flux: FluxOut) -> dict:
    d = {k: _np(getattr(flux, k)) for k in FLUXOUT_FIELDS}
    for name in ("ncat_fluxes", "transport_checks"):
        d[name] = {k: _np(v) for k, v in getattr(flux, name).items()}
    return d


def tree_to_numpy(tree, prefix: str = "") -> dict:
    """Flatten nested dicts / sequences / named tuples / dataclasses of
    tensors (or of anything numpy converts) into {dotted key: array}; None
    leaves and static grid attributes drop."""
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {prefix: _np(tree)}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)
                 if f.name not in ("bc", "nx_global", "ny_global")]
    elif isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(tree_to_numpy(v, f"{prefix}.{k}" if prefix else str(k)))
    return out
