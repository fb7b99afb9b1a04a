"""Model driver (PyTorch port of the initialization part of
cice_tpu/model/driver.py; reference CICE_InitMod.F90 `cice_init`,
ice_init.F90 `set_state_var`:3266).

`Model` owns config, grid, static tables, forcing and the prognostic state
on one device. `run_dynamics(n)` advances n dynamics-transport supercycles
(`step_dyn_transport`); the full coupled `Model.step`/`Model.run` come with
ROADMAP: slice 2.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants as cst
from ..columns import itd as itd_mod
from ..columns.thermo_vertical import (bl99_salinity, enthalpy_ice,
                                       enthalpy_snow, melting_temps)
from ..core.grid import Grid, make_grid
from .flux import zeros_forcing
from .forcing import default_ocn, get_forcing
from .state import State, zeros_state
from .step import ModelStatic, step_dyn_transport


def _scalar(v, dtype, device) -> torch.Tensor:
    """0-d tensor of v in `dtype` (a bare Python float in torch.where
    would round through the default float32)."""
    return torch.tensor(float(v), dtype=dtype, device=device)


def set_state_var(cfg, grid: Grid, state: State, Tf) -> State:
    """Initial ice distribution (reference set_state_var, ice_ic='default'):
    ice poleward of 60 degrees over ocean, parabolic ITD, linear
    temperature profile between Tsfc and Tf."""
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

    if cfg.thermo.ktherm == 2:
        raise NotImplementedError(
            "mushy (ktherm=2) initial enthalpy is not ported yet (ROADMAP: "
            "column options)")
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
    if "fsd" in trcrn:
        f = torch.zeros_like(trcrn["fsd"])
        f[:, 0] = 1.0
        trcrn["fsd"] = f

    def _init_bgc(nm, v0):
        if nm not in trcrn:
            return
        m = aicen > 0
        if trcrn[nm].ndim == 4:
            m = m[:, None]
        trcrn[nm] = torch.where(m, _scalar(v0, dtp, dev), 0.0).expand_as(
            trcrn[nm]).clone()

    if "bgc_Nit" in trcrn:
        _init_bgc("bgc_Nit", cfg.zbgc.nit_data)
        _init_bgc("bgc_N", 0.5)
    for nm, v0 in (("bgc_N2", 0.3), ("bgc_N3", 0.2),
                   ("bgc_Am", cfg.zbgc.amm_data),
                   ("bgc_Sil", cfg.zbgc.sil_data),
                   ("bgc_DMSPp", 0.1), ("bgc_DMSPd", cfg.zbgc.dms_data),
                   ("bgc_DMS", cfg.zbgc.dms_data), ("bgc_PON", 0.1),
                   ("bgc_DON", 1.0), ("bgc_Fed", cfg.zbgc.fed_data),
                   ("bgc_Fep", 0.1), ("bgc_hum", cfg.zbgc.hum_data),
                   ("bgc_DOC1", cfg.zbgc.doc_data),
                   ("bgc_DOC2", cfg.zbgc.doc_data),
                   ("bgc_DOC3", cfg.zbgc.doc_data),
                   ("bgc_DIC1", cfg.zbgc.dic_data)):
        _init_bgc(nm, v0)
    if "fbri" in trcrn:
        trcrn["fbri"] = torch.where(aicen > 0, 1.0, 0.0).to(dtp)
    if "rsnw" in trcrn:
        trcrn["rsnw"] = torch.full_like(trcrn["rsnw"], cfg.snow.rsnw_fall)
        trcrn["smice"] = torch.where(
            vsnon[:, None] > 0,
            cst.rhos * vsnon[:, None] / torch.clamp(aicen[:, None], min=1e-6)
            / cfg.domain.nslyr, 0.0).to(dtp)

    sst = torch.where(icemask, Tf, torch.clamp(Tf, min=-1.0)).to(dtp)
    return state.replace(aicen=aicen, vicen=vicen, vsnon=vsnon, trcrn=trcrn,
                         sst=sst)


class Model:
    """Standalone model instance on one device (cice_init equivalent)."""

    def __init__(self, cfg, grid: Optional[Grid] = None, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Model(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        if cfg.setup.runtype == "continue":
            raise NotImplementedError(
                "restarts are not ported yet (ROADMAP: restart and history)")
        self.cfg = cfg
        self.device = device
        self.grid = grid if grid is not None else make_grid(cfg, device)
        self.static = ModelStatic.build(cfg)
        self.forcing = zeros_forcing(self.grid.shape, cfg.np_dtype, device)
        if cfg.forcing.default_season == "summer":
            warm = torch.full(self.grid.shape, 273.15 + 2.0,
                              dtype=cfg.np_dtype, device=device)
            self.forcing = self.forcing.replace(Tair=warm, potT=warm)
        self.forcing = default_ocn(self.grid, cfg, self.forcing)
        self.state = zeros_state(cfg, self.grid)
        if cfg.setup.ice_ic == "default":
            self.state = set_state_var(cfg, self.grid, self.state,
                                       self.forcing.Tf)
        self.istep = 0
        self.dyn_diags: dict = {}
        self.tchecks: dict = {}

    @property
    def elapsed_seconds(self) -> float:
        return self.istep * self.cfg.setup.dt

    def run_dynamics(self, n: int = 1) -> State:
        """Advance n thermo steps of the dynamics-transport supercycle,
        with the forcing updated each step."""
        cfg = self.cfg
        if cfg.forcing.calc_strair:
            raise NotImplementedError(
                "calc_strair=True needs the thermodynamic boundary layer "
                "(ROADMAP: slice 2); use forcing.calc_strair=False")
        dt = cfg.setup.dt
        for _ in range(n):
            t = self.elapsed_seconds
            fc = get_forcing(cfg, self.grid, t, 1.0 + t / cst.secday,
                             self.state.aice, self.forcing)
            self.forcing = fc
            self.state, self.dyn_diags, self.tchecks = step_dyn_transport(
                self.static, self.grid, self.state, fc, fc.strax, fc.stray,
                dt)
            self.istep += 1
        return self.state
