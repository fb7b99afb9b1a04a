"""Atmospheric and oceanic forcing (PyTorch port of
cice_tpu/model/forcing.py; reference ice_forcing.F90), for the forcing of
the configurations the reference carries: the Hunke (2001) box2001
rotating winds (box2001_data_atm :5112-5202) over the default ocean.
"""

from __future__ import annotations

import math

import torch

from .. import constants as cst
from ..columns.ocean import freezing_temperature
from .flux import Forcing, zeros_forcing


def _full(grid, v, dtype):
    return torch.full(grid.shape, v, dtype=dtype, device=grid.device)


# ---------------------------------------------------------------------------
# analytic wind and current fields
# ---------------------------------------------------------------------------

def _ij(grid, dtype):
    """The 1-based global column and row of each cell over the global
    extents."""
    ny, nx = grid.shape
    dev = grid.device
    ii = (torch.arange(0, nx, dtype=dtype, device=dev) + 1.0)[None, :] / nx
    jj = (torch.arange(0, ny, dtype=dtype, device=dev) + 1.0)[:, None] / ny
    return ii, jj


def box2001_atm(grid, timesecs: float, aice, fc: Forcing) -> Forcing:
    """Hunke (2001) rotating wind field, defined at U points."""
    ny, nx = grid.shape
    period = 4.0 * cst.secday
    ii, jj = _ij(grid, aice.dtype)
    st = math.sin(2.0 * math.pi * (timesecs % period) / period)
    ones = torch.ones((ny, nx), dtype=aice.dtype, device=aice.device)
    uatm = 5.0 + (st - 3.0) * torch.sin(2.0 * math.pi * ii) * \
        torch.sin(math.pi * jj)
    vatm = 5.0 + (st - 3.0) * torch.sin(math.pi * ii) * \
        torch.sin(2.0 * math.pi * jj)
    uatm = uatm * ones
    vatm = vatm * ones
    wind = torch.sqrt(uatm ** 2 + vatm ** 2)
    tau = fc.rhoa * 0.0012 * wind
    return fc.replace(uatm=uatm, vatm=vatm, wind=wind,
                      strax=aice * tau * uatm, stray=aice * tau * vatm)


def default_ocn(grid, cfg, fc: Forcing) -> Forcing:
    sss = _full(grid, 34.0, fc.sss.dtype)
    Tf = freezing_temperature(sss, cfg.thermo.tfrz_option)
    return fc.replace(sss=sss, Tf=Tf)


# ---------------------------------------------------------------------------
# the per-step forcing (get_forcing_atmo / get_forcing_ocn analogue)
# ---------------------------------------------------------------------------

def get_forcing(cfg, grid, timesecs: float, yday: float, aice,
                fc: Forcing | None = None) -> Forcing:
    """The Forcing at the current time: the box2001 winds over `fc` (the
    default ocean when None)."""
    if fc is None:
        fc = zeros_forcing(grid.shape, cfg.np_dtype, grid.device)
        fc = default_ocn(grid, cfg, fc)
    fc = box2001_atm(grid, timesecs, aice, fc)
    return fc.replace(yday=torch.tensor(yday, dtype=fc.wind.dtype,
                                        device=fc.wind.device))
