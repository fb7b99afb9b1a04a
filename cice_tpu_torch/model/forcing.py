"""Atmospheric & oceanic forcing (PyTorch port of the analytic part of
cice_tpu/model/forcing.py): the Hunke (2001) box2001 rotating winds and gyre
currents (reference box2001_data_atm ice_forcing.F90:5112-5202,
box2001_data_ocn :5206-5251) and the default ocean. File datasets, the
synthetic seasonal cycle and wave spectra wait for ROADMAP: forcing files,
coupling and I/O.
"""

from __future__ import annotations

import math

import torch

from .. import constants as cst
from ..columns.ocean import freezing_temperature
from .flux import Forcing, zeros_forcing


def _ij(grid, dtype):
    ny, nx = grid.shape
    dev = grid.device
    ii = (torch.arange(nx, dtype=dtype, device=dev) + 1.0)[None, :] / nx
    jj = (torch.arange(ny, dtype=dtype, device=dev) + 1.0)[:, None] / ny
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


def box2001_ocn(grid, fc: Forcing) -> Forcing:
    ny, nx = grid.shape
    dt = fc.uocn.dtype
    ii, jj = _ij(grid, dt)
    ones = torch.ones((ny, nx), dtype=dt, device=fc.uocn.device)
    uocn = (0.2 * jj - 0.1) * ones
    vocn = (-0.2 * ii + 0.1) * ones
    return fc.replace(uocn=uocn, vocn=vocn)


def default_ocn(grid, cfg, fc: Forcing) -> Forcing:
    sss = torch.full(grid.shape, 34.0, dtype=fc.sss.dtype,
                     device=fc.sss.device)
    Tf = freezing_temperature(sss, cfg.thermo.tfrz_option)
    return fc.replace(sss=sss, Tf=Tf)


def get_forcing(cfg, grid, timesecs: float, yday: float, aice,
                fc: Forcing | None = None, year: int | None = None,
                sec_of_year: float | None = None) -> Forcing:
    """Build/update the Forcing for the current time (analytic modes).
    `year`/`sec_of_year` from the model Calendar address the file datasets
    (leap-aware record addressing; ROADMAP A7); without them a noleap
    reconstruction from `timesecs` applies. The analytic modes ported here
    do not read them."""
    if year is None:
        year = cfg.setup.year_init + int(timesecs // (365.0 * cst.secday))
    if sec_of_year is None:
        sec_of_year = timesecs % (365.0 * cst.secday)
    if fc is None:
        fc = zeros_forcing(grid.shape, cfg.np_dtype, grid.device)
        fc = default_ocn(grid, cfg, fc)
    atm = cfg.forcing.atm_data_type
    if atm == "box2001":
        fc = box2001_atm(grid, timesecs, aice, fc)
    else:
        raise NotImplementedError(
            f"atm_data_type={atm!r} is not ported yet (ROADMAP: forcing "
            "files, coupling and I/O)")
    ocn = cfg.forcing.ocn_data_type
    if ocn == "box2001":
        fc = box2001_ocn(grid, fc)
    elif ocn != "default":
        raise NotImplementedError(
            f"ocn_data_type={ocn!r} is not ported yet (ROADMAP: forcing "
            "files, coupling and I/O)")
    if cfg.forcing.wave_spec_type != "none":
        raise NotImplementedError(
            "wave spectra are not ported yet (ROADMAP: column options)")
    return fc.replace(yday=torch.tensor(yday, dtype=fc.wind.dtype,
                                        device=fc.wind.device))
