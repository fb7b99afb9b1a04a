"""Runtime diagnostics: hemispheric totals, conservation, stability checks
(PyTorch port of cice_tpu/model/diagnostics.py; reference
ice_diagnostics.F90 `runtime_diags`, `check_umax`, the arbud/icebud budget
tables, and ice_diagnostics_bgc.F90 `bgc_diags`, `hbrine_diags`). All
results are 0-d tensors on the state's device, except the point probes
(`print_points_state`, `debug_ice`), which gather their columns on the
device and come to the host in one read per call.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import constants as cst
from ..columns.ponds import pond_reservoir_mass
from ..core.grid import Grid
from .state import State


def runtime_diags(grid: Grid, state: State) -> Dict[str, torch.Tensor]:
    """Global & hemispheric diagnostics."""
    aice = state.aice
    vice = state.vice
    vsno = state.vsno
    tarea = grid.tarea * grid.hm
    nh = grid.TLAT > 0.0
    sh = ~nh

    def hemi(field, mask):
        return torch.sum(field * tarea * mask)

    ext = (aice > 0.15).to(aice.dtype)   # extent: 15% concentration
    uarea = grid.uarea * grid.uvm
    speed2 = state.uvel ** 2 + state.vvel ** 2
    return {
        "area_nh": hemi(aice, nh), "area_sh": hemi(aice, sh),
        "extent_nh": hemi(ext, nh), "extent_sh": hemi(ext, sh),
        "volume_nh": hemi(vice, nh), "volume_sh": hemi(vice, sh),
        "snow_nh": hemi(vsno, nh), "snow_sh": hemi(vsno, sh),
        "ke": 0.5 * torch.sum(speed2 * uarea),
        "umax": torch.sqrt(speed2).max(),
        "aice_max": aice.max(),
        "hmax": torch.where(aice > cst.puny,
                            vice / torch.clamp(aice, min=cst.puny),
                            0.0).max(),
        "sst_mean": torch.sum(state.sst * tarea) /
        torch.clamp(torch.sum(tarea), min=1.0),
    }


def bgc_diags(grid: Grid, state: State) -> Dict[str, torch.Tensor]:
    """BGC tracer totals and means: for each `bgc_*` tracer the
    area-integrated cell content (`<name>_tot`) and its mean over the
    ice-covered area (`<name>_mean`). A z tracer (ncat, nblyr, ny, nx)
    counts its mean over the bio layers: the JAX package's function
    multiplies it by aicen directly, which fails unless ncat == nblyr."""
    tarea = grid.tarea * grid.hm
    d: Dict[str, torch.Tensor] = {}
    aice_w = torch.clamp(torch.sum(state.aice * tarea), min=cst.puny)
    for name, trc in state.trcrn.items():
        if not name.startswith("bgc_"):
            continue
        if trc.dim() == 4:
            trc = trc.mean(1)
        cell = torch.sum(trc * state.aicen, dim=0)      # cell-mean content
        d[f"{name}_tot"] = torch.sum(cell * tarea)
        d[f"{name}_mean"] = d[f"{name}_tot"] / aice_w
    return d


def hbrine_diags(grid: Grid, state: State) -> Dict[str, torch.Tensor]:
    """Brine-height diagnostics: the mean fbri and the mean brine height
    over the ice-covered area ({} without the brine tracer)."""
    if "fbri" not in state.trcrn:
        return {}
    tarea = grid.tarea * grid.hm
    fbri = state.trcrn["fbri"]
    hin = torch.where(state.aicen > cst.puny,
                      state.vicen / torch.clamp(state.aicen, min=cst.puny),
                      0.0)
    hbri = torch.sum(fbri * hin * state.aicen, dim=0)
    aice_w = torch.clamp(torch.sum(state.aice * tarea), min=cst.puny)
    return {
        "fbri_mean": torch.sum(torch.sum(fbri * state.aicen, dim=0) * tarea)
        / aice_w,
        "hbri_mean": torch.sum(hbri * tarea) / aice_w,
    }


def _energy_field(state: State, acc=None):
    """Per-cell ice+snow enthalpy (J/m^2)."""
    to = (lambda t: t) if acc is None else (lambda t: t.to(acc))
    qice = to(state.trcrn["qice"])
    qsno = to(state.trcrn["qsno"])
    return (torch.sum(qice.mean(dim=1) * to(state.vicen), dim=0)
            + torch.sum(qsno.mean(dim=1) * to(state.vsnon), dim=0))


def total_energy(grid: Grid, state: State) -> torch.Tensor:
    """Total ice+snow enthalpy (J): conservation oracle."""
    return torch.sum(_energy_field(state) * (grid.tarea * grid.hm))


def total_water_mass(grid: Grid, state: State) -> torch.Tensor:
    """Total ice+snow water mass (kg): fresh-water conservation oracle."""
    w = grid.tarea * grid.hm
    return torch.sum((cst.rhoi * state.vice + cst.rhos * state.vsno) * w)


def total_pond_mass(grid: Grid, state: State,
                    pond_lvl: Optional[bool] = None) -> torch.Tensor:
    """Melt-pond water mass (kg, liquid + lid water-equivalent), by the same
    reservoir formula as the model step's fresh-flux assembly."""
    tr = state.trcrn
    if "apnd" not in tr or "hpnd" not in tr:
        return torch.zeros((), dtype=state.aicen.dtype,
                           device=state.aicen.device)
    if pond_lvl is None:
        pond_lvl = "alvl" in tr
    pond = pond_reservoir_mass(tr, state.aicen, pond_lvl)
    return torch.sum(pond * (grid.tarea * grid.hm))


def hemispheric_budgets(grid: Grid, state_pre: State, state_post: State,
                        flux, fc, dt: float,
                        frazil_in_fresh: bool = False,
                        pond_lvl: Optional[bool] = None
                        ) -> Dict[str, torch.Tensor]:
    """Heat & freshwater budget closure over a step.

    Water: the ice+snow(+pond) mass change must equal the time-integrated
    boundary mass fluxes (snowfall and rain intercepted by ice, evap, minus
    the fresh flux to the ocean), with the frazil new-ice mass re-added
    when update_ocn_f=false keeps it out of the coupler fresh flux. The
    identity is exact in the discretization: `water_residual` ~ roundoff.
    Heat: the enthalpy change against absorbed shortwave, net surface
    exchange and the ocean heat sink; `heat_residual` is reported, not
    fatal. Accumulates in float64: f32 global totals of ~1e14 kg carry
    ~1e9 kg of summation noise that would mask real leaks.
    """
    acc = torch.float64
    w = (grid.tarea * grid.hm).to(acc)
    nh = grid.TLAT > 0.0
    if pond_lvl is None:
        pond_lvl = "alvl" in state_pre.trcrn

    def tot(f):
        return torch.sum(f.to(acc) * w)

    def hemi2(f):
        s = f.to(acc) * w
        return (torch.sum(torch.where(nh, s, 0.0)),
                torch.sum(torch.where(nh, 0.0, s)))

    def pond_field(state):
        if "apnd" not in state.trcrn or "hpnd" not in state.trcrn:
            return torch.zeros(grid.shape, dtype=acc, device=w.device)
        tr_acc = {k: state.trcrn[k].to(acc)
                  for k in ("apnd", "hpnd", "ipnd", "alvl")
                  if k in state.trcrn}
        return pond_reservoir_mass(tr_acc, state.aicen.to(acc), pond_lvl)

    def mass_field(state):
        """Per-cell ice+snow+pond mass (kg/m^2): the budget takes the
        pre/post difference per cell before the global sum."""
        return (cst.rhoi * state.vice.to(acc) +
                cst.rhos * state.vsno.to(acc) + pond_field(state))

    aice0 = state_pre.aice
    dM = torch.sum((mass_field(state_post) - mass_field(state_pre)) * w)
    snow_in = tot(fc.fsnow * aice0)
    rain_in = tot(fc.frain * aice0)
    evap_in = tot(flux.evap)
    fresh_out = tot(flux.fresh)
    frazil_mass = tot(flux.frazil) * cst.rhoi / dt   # m/step -> kg/m^2/s
    water_in = dt * (snow_in + rain_in + evap_in - fresh_out)
    if not frazil_in_fresh:
        water_in = water_in + dt * frazil_mass
    water_res = dM - water_in

    dE = torch.sum((_energy_field(state_post, acc)
                    - _energy_field(state_pre, acc)) * w)
    sw_abs = tot(flux.fswabs - flux.fswthru)
    lw_net = tot(fc.flw * aice0 + flux.flwout)
    turb = tot(flux.fsens + flux.flat)
    ocn_heat = tot(flux.fhocn)
    # stored enthalpy is measured against melted water at 0 C, so freezing
    # dM kg of water stores ~ -Lfresh*dM without any boundary heat flux
    dpond = torch.sum((pond_field(state_post) - pond_field(state_pre)) * w)
    latent_store = -cst.Lfresh * (dM - dpond)
    heat_in = dt * (sw_abs + lw_net + turb - ocn_heat) + latent_store
    heat_res = dE - heat_in

    fresh_nh, fresh_sh = hemi2(flux.fresh)
    fhocn_nh, fhocn_sh = hemi2(flux.fhocn)
    return {
        "dE": dE, "heat_in": heat_in, "heat_residual": heat_res,
        "sw_abs": sw_abs, "lw_net": lw_net, "turb": turb,
        "ocn_heat": ocn_heat,
        "dM": dM, "water_in": water_in, "water_residual": water_res,
        "snow_in": snow_in, "rain_in": rain_in, "evap_in": evap_in,
        "fresh_out": fresh_out, "frazil_mass": frazil_mass,
        "fresh_nh": fresh_nh, "fresh_sh": fresh_sh,
        "fhocn_nh": fhocn_nh, "fhocn_sh": fhocn_sh,
    }


def check_state(state: State,
                umax_stab: float = 1.0) -> Dict[str, torch.Tensor]:
    """NaN/instability watchdog: cheap device-side flags that Model.step
    polls to abort early."""
    umax = torch.sqrt(state.uvel ** 2 + state.vvel ** 2).max()
    bad = ~(torch.isfinite(state.aicen).all()
            & torch.isfinite(state.vicen).all()
            & torch.isfinite(state.uvel).all()
            & torch.isfinite(state.sst).all())
    return {"umax": umax, "unstable": umax > umax_stab, "nonfinite": bad}


def probe_points(grid: Grid, latpnt=(90.0, -65.0),
                 lonpnt=(0.0, -45.0)) -> List[dict]:
    """The T cells nearest each (latpnt, lonpnt) probe in degrees
    (reference print_points, ice_diagnostics.F90:30): [{"j", "i", "lat",
    "lon"}]. Reads the grid's coordinates on the host; `Model` finds the
    points once."""
    lat = grid.TLAT.detach().cpu().numpy() * cst.rad_to_deg
    lon = grid.TLON.detach().cpu().numpy() * cst.rad_to_deg
    out = []
    for plat, plon in zip(latpnt, lonpnt):
        d2 = (lat - plat) ** 2 + (np.mod(lon - plon + 180, 360) - 180) ** 2
        j, i = np.unravel_index(np.argmin(d2), d2.shape)
        out.append(dict(j=int(j), i=int(i), lat=float(lat[j, i]),
                        lon=float(lon[j, i])))
    return out


#: the per-point values of `print_points_state`, in order
POINT_KEYS = ("aice", "vice", "vsno", "uvel", "vvel", "sst", "Tsfc")


def print_points_state(grid: Grid, state: State, latpnt=(90.0, -65.0),
                       lonpnt=(0.0, -45.0),
                       points: Optional[List[dict]] = None) -> List[dict]:
    """Per-point diagnostic probes (reference print_points / print_state,
    ice_diagnostics.F90:30,115): at each probe point the cell's position
    and its aice, vice, vsno, uvel, vvel, sst and area-weighted surface
    temperature. `points` (from `probe_points`) saves finding the cells
    again. The values are gathered on the device and read once."""
    pts = points if points is not None else probe_points(grid, latpnt,
                                                         lonpnt)
    dev = state.aicen.device
    jj = torch.tensor([p["j"] for p in pts], device=dev)
    ii = torch.tensor([p["i"] for p in pts], device=dev)
    aice = state.aice[jj, ii]
    tsum = (state.trcrn["Tsfcn"][:, jj, ii] * state.aicen[:, jj, ii]).sum(0)
    vals = torch.stack([aice, state.vice[jj, ii], state.vsno[jj, ii],
                        state.uvel[jj, ii], state.vvel[jj, ii],
                        state.sst[jj, ii],
                        tsum / torch.clamp(aice, min=1e-11)])
    rows = vals.to(torch.float64).T.tolist()
    return [dict(p, **dict(zip(POINT_KEYS, r))) for p, r in zip(pts, rows)]


def debug_ice(grid: Grid, state: State, j: int, i: int,
              stage: str = "") -> dict:
    """Full column dump at a debug point (reference debug_ice/print_state
    with the debug_model_{step,i,j} namelist, ice_diagnostics.F90:38-46,
    CICE_RunMod.F90:186-191): every prognostic variable at (j, i), as
    nested lists of Python floats. Gathered on the device, read once."""
    cols = {"aicen": state.aicen[:, j, i], "vicen": state.vicen[:, j, i],
            "vsnon": state.vsnon[:, j, i], "uvel": state.uvel[j, i],
            "vvel": state.vvel[j, i]}
    cols.update({name: arr[..., j, i] for name, arr in state.trcrn.items()})
    flat = torch.cat([c.reshape(-1).to(torch.float64)
                      for c in cols.values()]).tolist()
    out = {"stage": stage, "j": j, "i": i}
    k = 0
    for name, c in cols.items():
        n = c.numel()
        vals = np.asarray(flat[k:k + n]).reshape(tuple(c.shape))
        out[name] = float(vals) if c.ndim == 0 else vals.tolist()
        k += n
    return out
