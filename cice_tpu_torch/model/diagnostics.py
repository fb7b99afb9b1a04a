"""Runtime diagnostics: hemispheric totals, conservation, stability checks
(PyTorch port of cice_tpu/model/diagnostics.py; reference
ice_diagnostics.F90 `runtime_diags`, `check_umax`, the arbud/icebud budget
tables). All results are 0-d tensors on the state's device. `bgc_diags`,
`hbrine_diags`, `print_points_state` and `debug_ice` wait for ROADMAP A6/A7.
"""

from __future__ import annotations

from typing import Dict, Optional

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
