"""Prescribed-ice mode: ice concentration forced from data, thermodynamics
only (PyTorch port of cice_tpu/model/prescribed.py; reference
drivers/nuopc/cmeps/ice_prescribed_mod.F90, CESM's "prescribed ice" for
AMIP-style runs).

A monthly ice-coverage dataset supplies the cell ice fraction; the model
places that area in the category holding a climatological thickness (2 m
north, 1 m south), keeps the thermodynamics running and leaves dynamics,
ridging and transport off (the option set `prescribed` sets kdyn=0).
`Model.step` calls `prescribe_ice_state` after the forcing each step with
`prescribed_aice`: `ice_cov.npz` in `forcing.atm_data_dir` if there is one,
else an analytic seasonal cap.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import constants as cst
from ..core.grid import Grid
from .state import State

HIN_NH = 2.0     # prescribed ice thickness, northern hemisphere (m)
HIN_SH = 1.0     # southern hemisphere (m)
HSN_FRAC = 0.2   # snow depth as fraction of ice thickness


def prescribe_ice_state(cfg, grid: Grid, state: State, aice_data,
                        hin_max) -> State:
    """Overwrite the ITD state so the cell concentration matches
    `aice_data` (clipped to [0, 1], zero on land).

    The prescribed area goes to the single category whose bounds contain
    the hemispheric climatological thickness (reference
    ice_prescribed_mod.F90 `ice_prescribed_phys`); enthalpy and temperature
    tracers are kept where ice persists and start cold where ice appears;
    the velocities are zero."""
    ncat = cfg.domain.ncat
    dt = state.aicen.dtype
    aice_data = torch.clamp(torch.as_tensor(aice_data, dtype=dt,
                                            device=state.aicen.device),
                            0.0, 1.0) * grid.hm
    hin = torch.where(grid.TLAT > 0.0, HIN_NH, HIN_SH).to(dt)
    sel = torch.stack([(hin >= float(hin_max[n])) &
                       (hin < float(hin_max[n + 1])) for n in range(ncat)])
    aicen = torch.where(sel, aice_data[None], 0.0)
    vicen = aicen * hin[None]
    vsnon = torch.where(hin[None] > cst.puny, aicen * hin[None] * HSN_FRAC,
                        0.0)

    trcrn = dict(state.trcrn)
    newice = (aicen > cst.puny) & ~(state.aicen > cst.puny)
    # fill values as tensors of the tracer's dtype: a bare Python float in
    # torch.where rounds through float32
    for name, mask, v in (("Tsfcn", newice, -1.8),
                          ("qice", newice[:, None], -cst.rhoi * cst.Lfresh),
                          ("qsno", newice[:, None], -cst.rhos * cst.Lfresh),
                          ("sice", newice[:, None], 5.0)):
        if name in trcrn:
            t = trcrn[name]
            trcrn[name] = torch.where(mask, torch.full_like(t, v), t)
    return state.replace(aicen=aicen, vicen=vicen, vsnon=vsnon, trcrn=trcrn,
                         uvel=torch.zeros_like(state.uvel),
                         vvel=torch.zeros_like(state.vvel))


def load_ice_cov(cfg) -> Optional[np.ndarray]:
    """The (nmonth, ny, nx) `ice_cov` of `<atm_data_dir>/ice_cov.npz`, or
    None without an atmosphere directory or without that file."""
    d = cfg.forcing.atm_data_dir
    if not d:
        return None
    path = os.path.join(d, "ice_cov.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return np.asarray(z["ice_cov"])


def seasonal_ice_cap(grid: Grid, fyday: float) -> torch.Tensor:
    """The analytic prescribed cover without a dataset: 0.95 poleward of a
    seasonal edge (68 -+ 8 degrees north, 62 +- 6 south), float64. The
    edges are compared in float64, as the JAX package compares its float32
    latitudes with NumPy scalars."""
    phase = np.cos(2.0 * np.pi * (fyday - 80.0) / 365.0)
    edge_nh = (68.0 - 8.0 * phase) * np.pi / 180.0
    edge_sh = -(62.0 + 6.0 * phase) * np.pi / 180.0
    lat = grid.TLAT.to(torch.float64)
    cap = torch.full_like(lat, 0.95)
    return torch.where((lat > edge_nh) | (lat < edge_sh), cap, 0.0)


def prescribed_aice(grid: Grid, calendar, ice_cov=None) -> torch.Tensor:
    """This step's prescribed concentration: the month's plane of
    `ice_cov` (a (nmonth, ny, nx) tensor or array; months cycle), else the
    seasonal cap at the calendar's day."""
    if ice_cov is not None:
        return torch.as_tensor(ice_cov[(calendar.month - 1)
                                       % ice_cov.shape[0]],
                               device=grid.TLAT.device)
    return seasonal_ice_cap(grid, calendar.fyday)
