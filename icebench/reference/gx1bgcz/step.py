"""The coupled step of the configurations this reference carries: the
`ice` reference's step with the brine height and the z tracers in therm1
(a frozen copy of the program's model/step.py `step_therm1`,
`_therm1_bgc` and `model_step`, cut to BL99, ccsm3, the brine height and
the z tracers; reference ice_step_mod.F90 `step_therm1`:224 and
z_biogeochemistry, ice_step_mod.F90:1634-1782).

The dynamics, transport and ridging supercycle, therm2 and the ocean are
the `ice` reference's modules, unchanged; `check_supported` refuses what
neither carries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..ice import constants as cst
from ..ice.columns import itd as itd_mod
from ..ice.columns.atmo import atmo_boundary_layer
from ..ice.columns.ocean import ocean_mixed_layer
from ..ice.columns.ponds import (POND_DIAGS, pond_reservoir_mass,
                                 step_ponds)
from ..ice.columns.shortwave import shortwave_ccsm3
from ..ice.columns.thermo_itd import step_therm2
from ..ice.columns.thermo_vertical import (adjust_enthalpy, bl99_salinity,
                                           melting_temps,
                                           temperature_changes,
                                           thickness_changes)
from ..ice.core.grid import Grid, grid_average_X2Y
from ..ice.model.flux import Forcing, zeros_fluxout
from ..ice.model.state import State
from ..ice.model.step import (_CLEANUP_KEYS, _DYN_NCAT_KEYS, FBOT_MAX,
                              _mean_age, _phase, step_dyn_transport)
from ..ice.ops import lsum
from .columns.hbrine import update_hbrine
from .columns.zbgc_vertical import step_zbgc, z_tracer_names
from .state import tracer_registry

#: the options this copy carries, with the one value each must take
SUPPORTED = {
    "grid.grid_ice": "B", "dynamics.kdyn": 1, "dynamics.advection": "remap",
    "thermo.ktherm": 1, "shortwave.shortwave": "ccsm3",
    "forcing.formdrag": False, "forcing.highfreq": False,
    "forcing.atmbndy": "similarity", "forcing.atm_data_type": "ncar",
    "forcing.ocn_data_type": "clim", "forcing.wave_spec_type": "none",
    "forcing.default_season": "winter", "forcing.restore_ice": False,
    "forcing.restore_ocn": False, "setup.prescribed_ice": False,
    "tracers.tr_snow": False,
    "tracers.tr_fsd": False, "tracers.tr_iso": False,
    "tracers.tr_aero": False, "tracers.tr_brine": True,
    "zbgc.skl_bgc": False, "zbgc.z_tracers": True,
    "zbgc.tr_zaero": False, "zbgc.dEdd_algae": False}


def check_supported(cfg) -> None:
    """Raise ValueError for a configuration that needs an engine this copy
    does not carry, or that has no files to read its forcing from."""
    for key, want in SUPPORTED.items():
        group, name = key.split(".")
        got = getattr(getattr(cfg, group), name)
        if got != want:
            raise ValueError(f"{key}={got!r}: the reference carries only "
                             f"{want!r}")
    f = cfg.forcing
    if not (f.atm_data_dir and f.ocn_data_dir):
        raise ValueError("forcing.atm_data_dir and forcing.ocn_data_dir: "
                         "the reference reads its forcing from files")
    for name in ("nit_data", "amm_data", "sil_data", "dms_data", "don_data",
                 "fed_data", "doc_data", "dic_data"):
        if not isinstance(getattr(cfg.zbgc, name), (int, float)):
            raise ValueError(f"zbgc.{name}: the mixed-layer "
                             "concentrations must be numbers")


@dataclass(frozen=True)
class ModelStatic:
    """Per-run constants."""
    cfg: object
    hin_max: Tuple[float, ...]
    registry: tuple

    @classmethod
    def build(cls, cfg):
        check_supported(cfg)
        hin_max = tuple(itd_mod.category_bounds(
            cfg.domain.ncat, cfg.grid.kcatbound, cfg.domain.nilyr,
            cfg.thermo.kitd))
        return cls(cfg=cfg, hin_max=hin_max, registry=tracer_registry(cfg))


def brine_and_z_tracers(cfg, trcrn: dict, fc: Forcing, dt: float, *, an,
                        vicen, vsnon, th, sw, aice):
    """The brine height (update_hbrine), then the z tracers on the brine
    column (step_zbgc). Returns (trcrn, the planes for
    FluxOut.ncat_fluxes)."""
    z = cfg.zbgc
    hb = update_hbrine(dt, aicen=an, vicen=vicen, vsnon=vsnon,
                       fbri=trcrn["fbri"], qice=trcrn["qice"],
                       sice=trcrn["sice"], meltb=th.meltb, meltt=th.meltt,
                       congel=th.congel)
    trcrn["fbri"] = hb.fbri
    znames = [n for n in z_tracer_names(z) if n in trcrn]
    zout = step_zbgc(
        z, dt, aicen=an, vicen=vicen, vsnon=vsnon, fbri=trcrn["fbri"],
        qice=trcrn["qice"], sice=trcrn["sice"],
        trc={n: trcrn[n] for n in znames},
        frac={n: trcrn[n + "_mf"] for n in znames}, darcy_V=hb.darcy_V,
        fswthru=sw.fswint + sw.fswthru, Tbot=fc.Tf, meltt=th.meltt,
        meltb=th.meltb, congel=th.congel, frazil=torch.zeros_like(aice),
        snow={n: trcrn[n + "_sn"] for n in znames if n + "_sn" in trcrn},
        melts=th.melts)
    for n in znames:
        trcrn[n] = zout.trc[n]
        trcrn[n + "_mf"] = zout.frac[n]
        if n in zout.snow:
            trcrn[n + "_sn"] = zout.snow[n]
    planes = dict(zout.diags)
    planes.update({f"fzbgc_{n}": v for n, v in zout.flux_ocn.items()})
    return trcrn, planes


# ---------------------------------------------------------------------------
# step_therm1: per-category vertical thermodynamics (dense over categories)
# ---------------------------------------------------------------------------

def step_therm1(ms: ModelStatic, grid: Grid, state: State, fc: Forcing,
                dt: float):
    """Vertical thermo for all categories in one dense pass: the category
    axis is a leading broadcast dim of every (ncat, ny, nx) tensor.
    Returns (state, agg, hicen_old) with agg the dict of cell-mean fluxes."""
    cfg = ms.cfg
    nilyr = cfg.domain.nilyr
    nslyr = cfg.domain.nslyr

    salin = bl99_salinity(nilyr)
    Tmlt = melting_temps(salin)

    aice = state.aice
    # bottom boundary: ocean heat flux & bottom temperature; ustar from the
    # ice-ocean drag law on the relative velocity at T points
    du = grid_average_X2Y("S", state.uvel, "U", "T", grid) - fc.uocn
    dv = grid_average_X2Y("S", state.vvel, "U", "T", grid) - fc.vocn
    ustar = torch.clamp(torch.sqrt(cst.dragio * (du * du + dv * dv)),
                        min=cst.ustar_min)
    fbot = cst.cprho * cst.ch_mixed * ustar * (fc.Tf - state.sst)
    fbot = torch.clamp(fbot, -FBOT_MAX, 0.0)            # melting only
    Tbot = fc.Tf

    trcrn = dict(state.trcrn)
    Tsf_all = trcrn["Tsfcn"]          # (ncat, ny, nx)
    qice_all = trcrn["qice"]          # (ncat, nilyr, ny, nx)
    qsno_all = trcrn["qsno"]

    an, vin, vsn = state.aicen, state.vicen, state.vsnon
    mask = an > cst.puny
    mask_f = mask.to(an.dtype)
    am = torch.clamp(an, min=cst.puny)
    hin = torch.where(mask, vin / am, 0.0)
    hsn = torch.where(mask, vsn / am, 0.0)
    hicen_old = hin
    Tsf = torch.where(mask, Tsf_all, 0.0)
    qice = [torch.where(mask, qice_all[:, k], -cst.rhoi * cst.Lfresh)
            for k in range(nilyr)]
    qsno = [torch.where(mask, qsno_all[:, k], -cst.rhos * cst.Lfresh)
            for k in range(nslyr)]

    # shortwave partition (all categories at once)
    sw = shortwave_ccsm3(Tsf, hin, hsn, fc.swvdr, fc.swvdf, fc.swidr,
                         fc.swidf, cfg.shortwave, nilyr)

    # turbulent transfer coefficients
    co = atmo_boundary_layer(Tsf, fc.potT, fc.uatm, fc.vatm, fc.wind,
                             fc.zlvl, fc.Qa, fc.rhoa,
                             natmiter=cfg.forcing.natmiter,
                             atmiter_conv=cfg.forcing.atmiter_conv)

    hin_solve = torch.clamp(hin, min=cfg.thermo.hi_min)
    hilyr = hin_solve / nilyr
    hslyr = hsn / nslyr
    Isw = [sw.Iswabs[:, k] for k in range(nilyr)]
    salin_arg = [float(x) for x in salin]
    Tm_arg = [float(x) for x in Tmlt]

    ts, qsno_new, qice_new = temperature_changes(
        dt, nilyr, nslyr, Tsf=Tsf, qsno=qsno, qice=qice,
        salin=salin_arg, Tm=Tm_arg,
        hilyr=hilyr, hslyr=hslyr, Tbot=Tbot, fswsfc=sw.fswsfc,
        Iswabs=Isw, shcoef=co.shcoef, lhcoef=co.lhcoef,
        potT=fc.potT, Qa=fc.Qa, rhoa=fc.rhoa, flw=fc.flw,
        conduct=cfg.thermo.conduct, nit=cfg.thermo.nit)

    th, dzi, dzs = thickness_changes(
        dt, nilyr, nslyr, hin=hin_solve * mask_f,
        hsn=hsn, qice=qice_new, qsno=qsno_new,
        Tm=Tm_arg,
        Tbot=Tbot, fbot=fbot, fsurf=ts.fsurf, fcondtop=ts.fcondtop,
        fcondbot=ts.fcondbot, flat=ts.flat, sss=fc.sss,
        ice_ref_salinity=cfg.thermo.ice_ref_salinity)

    # snowfall accumulation
    dhs_snow = torch.where(mask, fc.fsnow * dt / cst.rhos, 0.0)
    hsn_new = th.hsn + dhs_snow
    qsnow_new = -cst.rhos * (cst.Lfresh - cst.cp_ice *
                             torch.clamp(fc.Tair - cst.Tffresh, max=0.0))
    # falling snow joins the top snow layer enthalpy-weighted
    qs_list = list(th.qsno)
    den = dzs[0] + dhs_snow
    qs_list[0] = torch.where(
        den > cst.puny,
        (th.qsno[0] * dzs[0] + qsnow_new * dhs_snow) /
        torch.clamp(den, min=cst.puny), th.qsno[0])
    dzs0 = list(dzs)
    dzs0[0] = den

    # vertical remap to uniform layers
    qice_r = adjust_enthalpy(dzi, th.qice, nilyr, th.hin)
    qsno_r = adjust_enthalpy(dzs0, qs_list, nslyr, hsn_new)

    fsalt_drain = torch.zeros_like(aice)

    hin_f = torch.where(mask, th.hin, 0.0)
    hsn_f = torch.where(mask, hsn_new, 0.0)
    vicen_out = torch.where(mask, hin_f * an, vin)
    vsnon_out = torch.where(mask, hsn_f * an, vsn)
    trcrn["Tsfcn"] = torch.where(mask, ts.Tsf, Tsf_all)
    trcrn["qice"] = torch.stack(
        [torch.where(mask, q, qice_all[:, k]) for k, q in enumerate(qice_r)],
        dim=1)
    trcrn["qsno"] = torch.stack(
        [torch.where(mask, q, qsno_all[:, k]) for k, q in enumerate(qsno_r)],
        dim=1)
    if "iage" in trcrn:
        trcrn["iage"] = trcrn["iage"] + dt

    # melt ponds
    if "apnd" in trcrn:
        trcrn, apeff, pond_flush, pond_diag = step_ponds(
            cfg, dt, aicen=an, vicen=vicen_out, vsnon=vsnon_out,
            trcrn=trcrn, Tsf=trcrn["Tsfcn"], meltt=th.meltt, melts=th.melts,
            frain=fc.frain, aice=aice, return_diag=True)
    else:
        apeff = torch.zeros_like(an)
        pond_flush = torch.zeros_like(an)
        pond_diag = {k: torch.zeros_like(an) for k in POND_DIAGS}

    # the brine height and the z tracers
    trcrn, bgc_fluxes = brine_and_z_tracers(cfg, trcrn, fc, dt, an=an,
                                            vicen=vicen_out,
                                            vsnon=vsnon_out, th=th, sw=sw,
                                            aice=aice)

    # aggregate cell-mean fluxes (weight: category area; sum over categories)
    w = torch.where(mask, an, 0.0)
    ws = lambda x: lsum(w * x, dim=0)
    zero2 = torch.zeros_like(aice)
    # the hi_min floor before the vertical solve adds (hi_min - hin) of ice
    # to thin masked categories; that mass is drawn from the ocean so the
    # freshwater identity stays exact (negative fresh contribution)
    fresh_clamp = -cst.rhoi * torch.where(mask, hin_solve - hin, 0.0) / dt
    agg = dict(
        fsens=ws(ts.fsens), flat=ws(ts.flat), flwout=ws(ts.flwout),
        evap=ws(th.evapn),
        fsalt_drain=fsalt_drain,
        fswabs=ws(sw.fswsfc + sw.fswint + sw.fswthru),
        fhocn=ws(th.fhocn), fresh=ws(th.freshn + fresh_clamp),
        fsalt=ws(th.fsaltn),
        fswthru=ws(sw.fswthru), meltt=ws(th.meltt), meltb=ws(th.meltb),
        melts=ws(th.melts), congel=ws(th.congel), snoice=ws(th.snoice),
        alvdr=ws(sw.alvdr), alvdf=ws(sw.alvdf), alidr=ws(sw.alidr),
        alidf=ws(sw.alidf), fsurf=ws(ts.fsurf), fcondtop=ws(ts.fcondtop),
        apond=ws(apeff), fpond=ws(pond_flush) * cst.rhofresh / dt,
        fcondbot=ws(ts.fcondbot), fswint=ws(sw.fswint),
        meltsliq=zero2,
    )
    # snow-covered fraction + broadband albedo partition by surface type
    asnow = hsn_f / (hsn_f + cst.snowpatch)
    alb_bb = (cst.awtvdr * sw.alvdr + cst.awtidr * sw.alidr +
              cst.awtvdf * sw.alvdf + cst.awtidf * sw.alidf)
    fr_pond = torch.clamp(apeff, 0.0, 1.0)
    fr_snow = torch.minimum(torch.clamp(asnow, min=0.0), 1.0 - fr_pond)
    fr_bare = torch.clamp(1.0 - fr_snow - fr_pond, 0.0, 1.0)
    agg["snowfrac"] = ws(asnow)
    agg["albsno"] = ws(alb_bb * fr_snow)
    agg["albpnd"] = ws(alb_bb * fr_pond)
    agg["albice"] = ws(alb_bb * fr_bare)
    # per-category boundary-layer wind stress aggregated per unit cell area
    # (sum of aicen * strair_n): the momentum balance's water drag scales
    # with the cell's ice area too, so a near-empty fringe cell feels a
    # dust-sized wind force
    agg["strairx"] = ws(co.strx)
    agg["strairy"] = ws(co.stry)
    # per-category cell-mean flux planes
    agg["ncat_fluxes"] = dict(
        fsurfn=w * ts.fsurf, fcondtopn=w * ts.fcondtop, flatn=w * ts.flat,
        fsensn=w * ts.fsens, melttn=w * th.meltt,
        # net surface heat flux causing melt (>=0, only when the surface
        # sits at the melting point)
        fmelttn=w * torch.where(ts.Tsf > -cst.puny,
                                torch.clamp(ts.fsurf - ts.fcondtop, min=0.0),
                                0.0),
        keffn_top=torch.where(mask, ts.keff_top, 0.0),
        evaps=ws(th.evapsn),
        apeffn=apeff,
        fswthrun=w * sw.fswthru,
        **{k + "n": w * v for k, v in pond_diag.items()})
    # shortwave scaling factor: net SW at current forcing/albedos over the
    # absorbed SW of the radiation pass (==1: radiation runs in-step)
    nsw = ((fc.swvdr + fc.swvdf + fc.swidr + fc.swidf) * lsum(w, dim=0)
           - (fc.swvdr * agg["alvdr"] + fc.swvdf * agg["alvdf"]
              + fc.swidr * agg["alidr"] + fc.swidf * agg["alidf"]))
    agg["ncat_fluxes"]["scale_factor"] = torch.where(
        agg["fswabs"] > cst.puny,
        nsw / torch.clamp(agg["fswabs"], min=cst.puny), 1.0)
    agg["ncat_fluxes"]["fsloss"] = zero2
    # the z network's interior diagnostics and the fluxes to the ocean of
    # the z tracers
    agg["ncat_fluxes"].update(bgc_fluxes)
    for k, v in pond_diag.items():
        agg[k] = ws(v)
    # 2m/10m reference diagnostics: ice-area-weighted over categories with
    # the open-water fraction taking the free-air values
    ow = torch.clamp(1.0 - aice, 0.0, 1.0)
    if co.Tref is not None:
        agg["Tref"] = ws(co.Tref) + ow * fc.potT
        agg["Qref"] = ws(co.Qref) + ow * fc.Qa
        agg["Uref"] = ws(co.Uref) + ow * fc.wind
    else:
        agg["Tref"] = fc.potT
        agg["Qref"] = fc.Qa
        agg["Uref"] = fc.wind
    # ocean heat consumed at the ice bottom (per unit cell area); it is
    # drawn from the mixed layer inside ocean_mixed_layer's budget
    agg["fbot_used"] = torch.where(aice > cst.puny, fbot * aice, 0.0)

    new_state = state.replace(vicen=vicen_out, vsnon=vsnon_out, trcrn=trcrn)
    return new_state, agg, hicen_old


# ---------------------------------------------------------------------------
# the full model step
# ---------------------------------------------------------------------------

def model_step(ms: ModelStatic, grid: Grid, state: State, fc: Forcing,
               dt: float, timer=None):
    """One full thermo+dyn timestep. Returns (state, FluxOut). `timer`, if
    given, is called with a phase name ('therm1', 'therm2', 'dyn',
    'transport', 'ridge', 'ocean') and
    returns a context manager that the phase runs in."""
    cfg = ms.cfg
    registry = ms.registry
    hin_max = ms.hin_max

    # tendency bookkeeping: thermo vs dynamics rates
    aice_init, vice_init = state.aice, state.vice
    vsno_init = state.vsno

    # pond freshwater reservoir before the thermo phases: the coupler fresh
    # flux below carries rain-on-ice minus the reservoir change so the
    # freshwater identity closes exactly
    pond_lvl = cfg.tracers.tr_pond_lvl
    pond_mass_pre = pond_reservoir_mass(state.trcrn, state.aicen, pond_lvl)
    age_init = _mean_age(state)

    # --- thermodynamics -------------------------------------------------
    with _phase(timer, "therm1"):
        state, agg, hicen_old = step_therm1(ms, grid, state, fc, dt)

    # wind stress on ice (T grid): from the per-category boundary layer of
    # step_therm1 under calc_strair, else the data stresses pass through
    if cfg.forcing.calc_strair:
        strairx_T = agg["strairx"]
        strairy_T = agg["strairy"]
    else:
        strairx_T = fc.strax
        strairy_T = fc.stray

    with _phase(timer, "therm2"):
        t2 = step_therm2(cfg, grid, state.aicen, state.vicen, state.vsnon,
                         state.trcrn, hicen_old=hicen_old,
                         frzmlt=state.frzmlt, Tf=fc.Tf, sst=state.sst, dt=dt,
                         hin_max=hin_max, registry=registry)
    state = state.replace(aicen=t2.aicen, vicen=t2.vicen, vsnon=t2.vsnon,
                          trcrn=t2.trcrn)

    # pond reservoir change over the thermo phases: positive = water
    # retained on the ice, deducted from the coupler fresh flux. Rain over
    # ice enters the ice system here; the uncaptured remainder runs off
    pond_mass_post = pond_reservoir_mass(state.trcrn, state.aicen, pond_lvl)
    fpond_net = (pond_mass_post - pond_mass_pre) / dt     # kg/m^2/s
    rain_on_ice = fc.frain * aice_init

    daidtt = (state.aice - aice_init) / dt
    dvidtt = (state.vice - vice_init) / dt
    dvsdtt = (state.vsno - vsno_init) / dt
    age_posttherm = _mean_age(state)
    dagedtt = (age_posttherm - age_init) / dt
    aice_posttherm, vice_posttherm = state.aice, state.vice
    vsno_posttherm = state.vsno

    # --- dynamics + transport + ridging ---------------------------------
    state, dyn, tchecks = step_dyn_transport(ms, grid, state, fc, strairx_T,
                                             strairy_T, dt, timer=timer)
    clean = {k: dyn.pop(f"{k}_cleanup") for k in _CLEANUP_KEYS}

    # --- ocean mixed layer / frzmlt -------------------------------------
    fbot_used = agg.pop("fbot_used")
    fhocn_ice = agg["fhocn"] + t2.fhocn + fbot_used + clean["fhocn"]
    with _phase(timer, "ocean"):
        if cfg.forcing.oceanmixed_ice:
            sst_new, frzmlt = ocean_mixed_layer(
                dt, sst=state.sst, Tf=fc.Tf, hmix=fc.hmix, qdp=fc.qdp,
                frzmlt_old=state.frzmlt, aice=state.aice,
                fhocn_ice=fhocn_ice, fswthru_ice=agg["fswthru"],
                fresh_unused=0.0, flw=fc.flw, swvdr=fc.swvdr,
                swvdf=fc.swvdf, swidr=fc.swidr, swidf=fc.swidf,
                potT=fc.potT, Qa=fc.Qa, rhoa=fc.rhoa, wind=fc.wind,
                uatm=fc.uatm, vatm=fc.vatm, zlvl=fc.zlvl)
        else:
            # SST comes from data; the freezing/melting potential is
            # diagnosed from it
            sst_new = fc.sst_data
            frzmlt = torch.clamp(
                cst.cprho * (fc.Tf - sst_new) * fc.hmix / dt,
                -1000.0, 1000.0)
    # melt/freeze onset day-of-year (Model.step resets them yearly)
    mlt_onset = torch.where((state.mlt_onset <= 0.0) & (agg["meltt"] > 0.0),
                            fc.yday, state.mlt_onset)
    frz_onset = torch.where((state.frz_onset <= 0.0) & (t2.frazil > 0.0),
                            fc.yday, state.frz_onset)
    state = state.replace(sst=sst_new, frzmlt=frzmlt,
                          mlt_onset=mlt_onset, frz_onset=frz_onset)

    zf = torch.zeros_like(aice_init)
    # update_ocn_f=False keeps the frazil mass fluxes out of the coupler
    # fresh/salt budget
    ocn_f = cfg.forcing.update_ocn_f
    flux = zeros_fluxout(grid.shape, state.aicen.dtype,
                         state.aicen.device).replace(
        fsens=agg["fsens"], flat=agg["flat"], flwout=agg["flwout"],
        evap=agg["evap"], fswabs=agg["fswabs"],
        strairx=strairx_T, strairy=strairy_T,
        fhocn=fhocn_ice,
        fresh=agg["fresh"] + rain_on_ice - fpond_net + clean["fresh"] +
              (t2.freshn if ocn_f else t2.freshn - t2.freshn_frazil),
        fsalt=agg["fsalt"] + agg["fsalt_drain"] + clean["fsalt"] +
              (t2.fsaltn if ocn_f else t2.fsaltn - t2.fsaltn_frazil),
        fswthru=agg["fswthru"],
        strocnx=dyn["strocnx"], strocny=dyn["strocny"],
        meltt=agg["meltt"], meltb=agg["meltb"], melts=agg["melts"],
        meltl=t2.meltl, congel=agg["congel"], frazil=t2.frazil,
        snoice=agg["snoice"], alvdr=agg["alvdr"], alvdf=agg["alvdf"],
        alidr=agg["alidr"], alidf=agg["alidf"],
        albice=agg["albice"],
        fsurf=agg["fsurf"], fcondtop=agg["fcondtop"],
        fbot=fbot_used, fcondbot=agg["fcondbot"], fswint=agg["fswint"],
        fpond=fpond_net, apeff=agg["apond"], meltsliq=agg["meltsliq"],
        snowfrac=agg["snowfrac"], albsno=agg["albsno"],
        albpnd=agg["albpnd"], dvsdtd=(state.vsno - vsno_posttherm) / dt,
        dvsdtt=dvsdtt, dagedtt=dagedtt,
        dagedtd=(_mean_age(state) - age_posttherm) / dt,
        dpnd_initial=agg["dpnd_initial"], dpnd_expon=agg["dpnd_expon"],
        dpnd_freebd=agg["dpnd_freebd"], dpnd_dlid=agg["dpnd_dlid"],
        ncat_fluxes={**agg["ncat_fluxes"],
                     **{k: dyn[k] for k in _DYN_NCAT_KEYS if k in dyn},
                     "dpnd_melt": t2.dpnd_melt,
                     "aice_init": aice_init},
        divu=dyn["divu"], shear=dyn["shear"], Delta=dyn["Delta"],
        strintx=dyn["strintx"], strinty=dyn["strinty"],
        taubx=dyn["taubx"], tauby=dyn["tauby"], strength=dyn["strength"],
        dardg1dt=dyn.get("dardg1dt", zf), dardg2dt=dyn.get("dardg2dt", zf),
        dvirdgdt=dyn.get("dvirdgdt", zf), opening=dyn.get("opening", zf),
        transport_checks=tchecks,
        daidtt=daidtt, dvidtt=dvidtt,
        daidtd=(state.aice - aice_posttherm) / dt,
        dvidtd=(state.vice - vice_posttherm) / dt,
        Tref=agg["Tref"], Qref=agg["Qref"], Uref=agg["Uref"])

    return state, flux
