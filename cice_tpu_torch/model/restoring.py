"""Ice and ocean restoring (nudging): regional-boundary and SST relaxation
(PyTorch port of cice_tpu/model/restoring.py; reference
cicecore/cicedyn/infrastructure/ice_restoring.F90 `ice_HaloRestore_init`
and `ice_HaloRestore`, the nudging of the ice state toward stored target
fields in a zone along open boundaries, and the SST restoring of
`ice_forcing`'s ocean data; forcing_nml `restore_ice`/`restore_ocn`,
`trestore` days).
"""

from __future__ import annotations

import numpy as np
import torch


def boundary_zone_weight(grid, width: int = 3) -> torch.Tensor:
    """Weight field: 1 at open or closed (non-cyclic) domain boundaries,
    decaying linearly to 0 over `width` cells (restore_cells semantics),
    zero on land. Built in numpy and uploaded once, in the grid's dtype."""
    ny, nx = grid.shape
    w = np.zeros((ny, nx))
    ramp = np.linspace(1.0, 0.0, width + 1)[:-1]
    if grid.bc.ns in ("open", "closed"):
        for k in range(width):
            w[k, :] = np.maximum(w[k, :], ramp[k])
            w[ny - 1 - k, :] = np.maximum(w[ny - 1 - k, :], ramp[k])
    if grid.bc.ew in ("open", "closed"):
        for k in range(width):
            w[:, k] = np.maximum(w[:, k], ramp[k])
            w[:, nx - 1 - k] = np.maximum(w[:, nx - 1 - k], ramp[k])
    hm = grid.hm.detach().cpu().numpy().astype(np.float64)
    return torch.as_tensor(w * hm, dtype=grid.hm.dtype,
                           device=grid.hm.device)


def make_restore_target(cfg, state) -> dict:
    """Boundary-restore data (ice_HaloRestore_init, ice_restoring.F90:79):
    the category state and every tracer, copied. The source is the run's
    initial state, or the restart file `forcing.ice_data_file` (any of the
    port's restart formats: the regional/nested run whose boundary data
    comes from a parent run)."""
    src = state
    if cfg.forcing.ice_data_file:
        from ..io.restart import read_restart
        src, _ = read_restart(cfg.forcing.ice_data_file, state)
    return dict(aicen=src.aicen.clone(), vicen=src.vicen.clone(),
                vsnon=src.vsnon.clone(),
                trcrn={k: v.clone() for k, v in src.trcrn.items()})


def _rate(cfg, dt: float) -> float:
    """The fraction of the gap closed per step: dt / (trestore days),
    clipped to [0, 1]; 1 (outright replacement) for trestore <= 0 (the
    reference's ctime == 0 branch)."""
    tres = cfg.forcing.trestore
    if tres <= 0:
        return 1.0
    return min(max(dt / (tres * 86400.0), 0.0), 1.0)


def restore_ice(cfg, grid, state, target: dict, dt: float, zone=None):
    """Relax the boundary-zone ice state toward `target`
    (ice_HaloRestore, ice_restoring.F90:319): aicen, vicen, vsnon and every
    tracer of the target move by `zone * dt/trestore` of their gap each
    step; cells outside the zone are untouched."""
    if zone is None:
        zone = boundary_zone_weight(grid)
    c = _rate(cfg, dt) * zone[None]
    trcrn = dict(state.trcrn)
    for k, tgt in target["trcrn"].items():
        cur = trcrn[k]
        cc = c if cur.ndim == 3 else c[:, None]     # (ncat, L, ny, nx)
        trcrn[k] = cur + cc * (tgt - cur)
    return state.replace(
        aicen=state.aicen + c * (target["aicen"] - state.aicen),
        vicen=state.vicen + c * (target["vicen"] - state.vicen),
        vsnon=state.vsnon + c * (target["vsnon"] - state.vsnon),
        trcrn=trcrn)


def restore_sst(cfg, state, sst_data, dt: float):
    """Global SST relaxation toward the data SST (reference ocean restoring
    in get_forcing_ocn; trestore days; trestore <= 0 replaces it)."""
    if cfg.forcing.trestore <= 0:
        return state.replace(sst=sst_data)
    return state.replace(sst=state.sst + _rate(cfg, dt) *
                         (sst_data - state.sst))
