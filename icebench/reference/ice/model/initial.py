"""CICE's default initial state (ice_init.F90 `set_state_var`:3266,
ice_ic='default'; PyTorch port of cice_tpu/model/driver.py
`set_state_var`), for the tracers of the configurations the reference
carries (`model.step.check_supported`)."""

from __future__ import annotations

import torch

from .. import constants as cst
from ..columns import itd as itd_mod
from ..columns.thermo_vertical import (bl99_salinity, enthalpy_ice,
                                       enthalpy_snow, melting_temps)
from ..core.grid import Grid
from .state import State


def _scalar(v, dtype, device) -> torch.Tensor:
    """0-d tensor of v in `dtype` (a bare Python float in torch.where
    would round through the default float32)."""
    return torch.tensor(float(v), dtype=dtype, device=device)


def set_state_var(cfg, grid: Grid, state: State, Tf) -> State:
    """Initial ice distribution: ice poleward of 60 degrees over ocean,
    parabolic ITD, linear temperature profile between Tsfc and Tf."""
    ncat = cfg.domain.ncat
    nilyr, nslyr = cfg.domain.nilyr, cfg.domain.nslyr
    dtp = state.aicen.dtype
    dev = state.aicen.device
    hin_max = itd_mod.category_bounds(ncat, cfg.grid.kcatbound, nilyr,
                                      cfg.thermo.kitd)
    ainit, hinit = itd_mod.initial_itd_profile(ncat, hin_max)

    lat = grid.TLAT.detach().cpu().numpy() * cst.rad_to_deg
    tmask = grid.tmask.cpu().numpy()
    icemask = torch.as_tensor(tmask & ((lat > 60.0) | (lat < -60.0)),
                              device=dev)

    salin = bl99_salinity(nilyr)
    Tmlt = melting_temps(salin)

    aicen, vicen, vsnon = [], [], []
    Tsfc0 = torch.where(icemask, -5.0, 0.0).to(dtp)
    trcrn = dict(state.trcrn)
    for n in range(ncat):
        a = torch.where(icemask, _scalar(ainit[n], dtp, dev), 0.0)
        aicen.append(a)
        vicen.append(a * float(hinit[n]))
        vsnon.append(a * float(min(0.2, 0.2 * hinit[n])))
    aicen = torch.stack(aicen)
    vicen = torch.stack(vicen)
    vsnon = torch.stack(vsnon)

    qice = []
    for k in range(nilyr):
        zf = (k + 0.5) / nilyr
        Tlay = Tsfc0 * (1.0 - zf) + Tf * zf
        Tlay = torch.clamp(Tlay, max=float(Tmlt[k]) - 0.1)
        qice.append(enthalpy_ice(Tlay, float(Tmlt[k])))
    qice = torch.stack(qice)                     # (nilyr, ny, nx)
    qsno = enthalpy_snow(torch.clamp(Tsfc0, max=-1.0))

    shp = grid.shape
    trcrn["Tsfcn"] = Tsfc0.expand((ncat,) + shp).to(dtp).clone()
    trcrn["qice"] = qice[None].expand((ncat, nilyr) + shp).to(dtp).clone()
    trcrn["qsno"] = qsno[None, None].expand((ncat, nslyr) + shp).to(
        dtp).clone()
    trcrn["sice"] = torch.as_tensor(salin, dtype=dtp, device=dev)[
        None, :, None, None].expand((ncat, nilyr) + shp).clone()
    if "alvl" in trcrn:
        trcrn["alvl"] = torch.where(aicen > 0, 1.0, 0.0).to(dtp)
        trcrn["vlvl"] = torch.where(vicen > 0, 1.0, 0.0).to(dtp)
    if "FY" in trcrn:
        trcrn["FY"] = torch.where(aicen > 0, 1.0, 0.0).to(dtp)

    sst = torch.where(icemask, Tf, torch.clamp(Tf, min=-1.0)).to(dtp)
    return state.replace(aicen=aicen, vicen=vicen, vsnon=vsnon, trcrn=trcrn,
                         sst=sst)
