"""Timestep orchestration: the full coupled thermo + dynamics step (PyTorch
port of cice_tpu/model/step.py; reference ice_step_mod.F90 `step_therm1`:224,
`step_therm2`:639, `step_dyn_horiz`:969, `step_dyn_ridge`:1062,
`ocean_mixed_layer`:1485 and the loop body of CICE_RunMod.F90 `ice_step`).

Each phase is a dense tensor transformation over the global (ncat, ny, nx)
state. `model_step` is one full step; `step_dyn_transport` is its ndtd
dynamics/transport/ridging supercycle. Every option is ported; across
ranks (`ModelStatic.mesh`) with a whole state on every rank the EVP solve
of evp_algorithm='wide_halo' is split into the ranks' tiles, and the rest
of the step runs whole on every rank.

With the state sharded (a tile grid, `parallel.mesh.Mesh.tile_grid`) each
rank steps its tiles: every neighbour access goes through the tile-aware
`core.halo.shift`, every host decision reads a value agreed over the
ranks (`core.reductions.agreed`, given the tile grid's mesh), the B-grid
EVP of 'fused_pallas' and 'wide_halo' is the wide-halo solve on the tiles
(K1 on each padded tile on the card), 'standard_2d' the plain loop, EAP
the wide-halo loop of its subcycles (`parallel.evp_wide.eap_solve_wide`),
VP its solve on the tiles (`dynamics.vp`: the operator on the padded tile,
the inner products summed over the ranks), and K2/K3 run on padded tiles.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from .. import constants as cst
from ..columns import itd as itd_mod
from ..columns import mushy as mush
from ..columns.aero_iso import FAERO_DEFAULT, step_aerosols, step_isotopes
from ..columns.atmo import atmo_boundary_const, atmo_boundary_layer
from ..columns.ocean import ocean_mixed_layer
from ..columns.dedd import shortwave_dEdd
from ..columns.formdrag import drag_from_state
from ..columns.fsd import step_dyn_wave, step_fsd_thermo
from ..columns.hbrine import update_hbrine
from ..columns.ponds import (POND_DIAGS, pond_exposure, pond_reservoir_mass,
                             step_ponds)
from ..columns.ridging import ice_strength, ridge_ice
from ..columns.shortwave import shortwave_ccsm3
from ..columns.snow import step_snow
from ..columns.thermo_itd import step_therm2
from ..columns.zbgc import step_bgc_skl_net
from ..columns.zbgc_vertical import step_zbgc, z_tracer_names
from ..columns.thermo_vertical import (adjust_enthalpy, bl99_salinity,
                                       melting_temps, safe_mix,
                                       temp_from_enthalpy_snow,
                                       temperature_changes,
                                       thickness_changes)
from ..core.grid import Grid, grid_average_X2Y
from ..core.halo import TileBC, tile_mesh
from ..dynamics import evp_c
from ..dynamics.common import deformations_B, dyn_prep, evp_params
from ..dynamics.eap import eap_solve
from ..dynamics.evp import evp_ocean_stress, evp_solve
from ..dynamics.transport import ADVECT
from ..dynamics.vp import implicit_solver
from ..ops import lsum
from ..utils.timers import span
from .flux import Forcing, zeros_fluxout
from .state import State, tracer_registry

FBOT_MAX = 1000.0

#: dynamics diagnostics that model_step copies into FluxOut.ncat_fluxes
_DYN_NCAT_KEYS = (
    "dardg1ndt", "dardg2ndt", "dvirdgndt", "aparticn", "krdgn", "aredistn",
    "vredistn",
    # the native E/N-point planes of the C and CD grids and their
    # momentum-balance splits (_en_stress_splits)
    "strintxE", "strintyN", "strintyE", "strintxN", "taubxE", "taubyN",
    "taubyE", "taubxN", "strocnxE", "strocnyE", "strocnxN", "strocnyN",
    "strairxE", "strairyE", "strairxN", "strairyN", "strcorxE", "strcoryE",
    "strcorxN", "strcoryN", "strtltxE", "strtltyE", "strtltxN", "strtltyN",
    "araftn", "vraftn", "dpnd_ridge",
    # the EAP yield-surface stress
    "yieldstress11", "yieldstress12", "yieldstress22")
_CLEANUP_KEYS = ("fresh", "fsalt", "fhocn")


@contextlib.contextmanager
def _phase(timer, name):
    """Context of one named phase: the program's range "ice:<name>"
    (utils/timers.py `span`) inside `timer(name)` if a timer is given (any
    callable returning a context manager)."""
    with contextlib.nullcontext() if timer is None else timer(name):
        with span("ice:" + name):
            yield


#: the values of `dynamics.advection`: the exact remap, the transports of
#: dynamics/transport.py, or no transport
ADVECTIONS = ("remap", "none") + tuple(ADVECT)


def check_ported(cfg) -> None:
    """Raise ValueError for the combinations of options the port
    refuses (every option of the full step is ported).

    Two configurations on which the JAX package fails are refused: z
    tracers without the brine tracer (their transport parent `fbri` is not
    registered; the JAX package fails in its flat tracer table) and a
    non-numeric mixed-layer concentration such as 'clim' (the JAX package
    has no climatology reader and fails converting the string).

    kdyn 2 (EAP) and 3 (VP) are B-grid solvers: on a C or CD grid the
    JAX package runs them on the corner velocities while its C-grid
    transport reads the face velocities uvelE/vvelN, which nothing then
    updates. The port refuses that combination. An unknown `advection`
    is refused too (the JAX package runs upwind for any name it does not
    know, 'none' included); 'none' moves nothing, as in the reference."""
    t, d = cfg.tracers, cfg.dynamics
    if cfg.grid.grid_ice in ("C", "CD") and d.kdyn in (2, 3):
        raise ValueError(
            f"kdyn={d.kdyn} ({'EAP' if d.kdyn == 2 else 'VP'}) on "
            f"grid_ice={cfg.grid.grid_ice!r}: the solver steps the corner "
            "velocities while the C-grid transport moves the ice with the "
            "face velocities, which it leaves unchanged")
    if d.advection not in ADVECTIONS:
        raise ValueError(f"dynamics.advection={d.advection!r}: expected one "
                         f"of {ADVECTIONS}")
    z = cfg.zbgc
    if z.z_tracers and not t.tr_brine:
        raise ValueError(
            "zbgc.z_tracers=True needs tracers.tr_brine=True: the z tracers "
            "ride on the brine height tracer fbri, which only tr_brine "
            "registers")
    if z.skl_bgc or z.z_tracers:
        for f in dataclasses.fields(z):
            v = getattr(z, f.name)
            if f.name.endswith("_data") and not isinstance(v, (int, float)):
                raise ValueError(
                    f"zbgc.{f.name}={v!r}: the mixed-layer concentrations "
                    "must be numbers; no BGC climatology reader exists")


@dataclass(frozen=True)
class ModelStatic:
    """Per-run constants; `mesh` (parallel.mesh.Mesh) tiles the EVP solve
    of evp_algorithm='wide_halo' across ranks."""
    cfg: object
    hin_max: Tuple[float, ...]
    registry: tuple
    mesh: object = None

    @classmethod
    def build(cls, cfg, mesh=None):
        hin_max = tuple(itd_mod.category_bounds(
            cfg.domain.ncat, cfg.grid.kcatbound, cfg.domain.nilyr,
            cfg.thermo.kitd))
        return cls(cfg=cfg, hin_max=hin_max, registry=tracer_registry(cfg),
                   mesh=mesh)


# ---------------------------------------------------------------------------
# step_therm1: per-category vertical thermodynamics (dense over categories)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _const(v: float, dtype, device) -> torch.Tensor:
    """A 0-d tensor of v in `dtype`, uploaded once per (v, dtype,
    device)."""
    return torch.tensor(v, dtype=dtype, device=device)


def _therm1_bgc(cfg, trcrn: dict, fc: Forcing, dt: float, *, an, vicen,
                vsnon, th, sw, aice, timer=None):
    """The tracer physics of step_therm1 after the ponds: aerosols and
    isotopes (icepack_aerosol / icepack_isotope), the brine height
    (update_hbrine) and, on the brine column, the z tracers (z_tracers /
    solve_zbgc). With z tracers the brine height and the z tracers run in
    the phase 'zbgc' (`_phase`, inside therm1's). Returns (trcrn, the
    planes for FluxOut.ncat_fluxes)."""
    t, z = cfg.tracers, cfg.zbgc
    planes = {}
    if t.tr_aero and "aerosno" in trcrn:
        # the coupler's per-species deposition where it has one per
        # species, else the standalone defaults
        fa = fc.faero_atm if fc.faero_atm.shape[0] == cfg.domain.n_aero \
            else None
        trcrn["aerosno"], trcrn["aeroice"], faero_ocn = step_aerosols(
            cfg, dt, aicen=an, vicen=vicen, vsnon=vsnon,
            aerosno=trcrn["aerosno"], aeroice=trcrn["aeroice"],
            melts=th.melts, meltt=th.meltt, snoice=th.snoice,
            fsnow=fc.fsnow, faero_atm=fa)
        planes["faero_ocn"] = faero_ocn
    if t.tr_iso and "isosno" in trcrn:
        fi = fc.fiso_atm if fc.fiso_atm.shape[0] == cfg.domain.n_iso \
            else None
        trcrn["isosno"], trcrn["isoice"], fiso_ocn = step_isotopes(
            cfg, dt, aicen=an, vsnon=vsnon, isosno=trcrn["isosno"],
            isoice=trcrn["isoice"], fsnow=fc.fsnow, melts=th.melts,
            snoice=th.snoice, fiso_atm=fi)
        planes["fiso_ocn"] = fiso_ocn
    if not (t.tr_brine and "fbri" in trcrn):
        return trcrn, planes
    znames = [n for n in z_tracer_names(z) if n in trcrn] \
        if z.z_tracers else []
    with _phase(timer, "zbgc") if znames else contextlib.nullcontext():
        hb = update_hbrine(dt, aicen=an, vicen=vicen, vsnon=vsnon,
                           fbri=trcrn["fbri"], qice=trcrn["qice"],
                           sice=trcrn["sice"], meltb=th.meltb,
                           meltt=th.meltt, congel=th.congel)
        trcrn["fbri"] = hb.fbri
        if znames:
            _z_tracers(z, trcrn, planes, fc, dt, znames, hb.darcy_V, an=an,
                       vicen=vicen, vsnon=vsnon, th=th, sw=sw, aice=aice)
    return trcrn, planes


def _z_tracers(z, trcrn: dict, planes: dict, fc: Forcing, dt: float,
               znames: list, darcy_V, *, an, vicen, vsnon, th, sw, aice):
    """The z tracers `znames` on the brine column (step_zbgc), in place in
    `trcrn`, with the z network's diagnostics and fluxes to the ocean
    added to `planes`."""
    zdep = None
    if z.tr_zaero and z.n_zaero > 0:
        # standalone deposition defaults (faero_default): BC1, BC2, then
        # the dust species
        zdep = {f"zaero{i+1}": _const(
                    FAERO_DEFAULT[min(i, len(FAERO_DEFAULT) - 1)],
                    aice.dtype, aice.device)
                for i in range(z.n_zaero)}
    zout = step_zbgc(
        z, dt, aicen=an, vicen=vicen, vsnon=vsnon, fbri=trcrn["fbri"],
        qice=trcrn["qice"], sice=trcrn["sice"],
        trc={n: trcrn[n] for n in znames},
        frac={n: trcrn[n + "_mf"] for n in znames}, darcy_V=darcy_V,
        fswthru=sw.fswint + sw.fswthru, Tbot=fc.Tf, meltt=th.meltt,
        meltb=th.meltb, congel=th.congel, frazil=torch.zeros_like(aice),
        zaero_dep=zdep,
        snow={n: trcrn[n + "_sn"] for n in znames if n + "_sn" in trcrn},
        melts=th.melts)
    for n in znames:
        trcrn[n] = zout.trc[n]
        trcrn[n + "_mf"] = zout.frac[n]
        if n in zout.snow:
            trcrn[n + "_sn"] = zout.snow[n]
    # interior-state and uptake diagnostics, and the net ice->ocean flux
    # of each z tracer (history fzaero/fN/fNit... families)
    planes.update(zout.diags)
    planes.update({f"fzbgc_{n}": v for n, v in zout.flux_ocn.items()})


def step_therm1(ms: ModelStatic, grid: Grid, state: State, fc: Forcing,
                dt: float, timer=None):
    """Vertical thermo for all categories in one dense pass: the category
    axis is a leading broadcast dim of every (ncat, ny, nx) tensor.
    Returns (state, agg, hicen_old) with agg the dict of cell-mean fluxes.
    `timer` is `model_step`'s: the z tracers run in its phase 'zbgc'."""
    cfg = ms.cfg
    check_ported(cfg)
    nilyr = cfg.domain.nilyr
    nslyr = cfg.domain.nslyr

    mushy = cfg.thermo.ktherm == 2
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

    # shortwave partition (all categories at once); 'dEdd_snicar_ad' takes
    # the delta-Eddington path too
    if cfg.shortwave.shortwave.startswith("dEdd"):
        apeff_rad = pond_exposure(cfg, aicen=an, vsnon=vsn, trcrn=trcrn)
        hpnd_rad = trcrn.get("hpnd", torch.zeros_like(an))
        aero_snow = None
        if cfg.tracers.tr_aero and "aerosno" in trcrn:
            # per-species snow loadings (SSL + interior) darken the top
            # snow layer
            asn = trcrn["aerosno"]
            aero_snow = [asn[:, 2 * s] + asn[:, 2 * s + 1]
                         for s in range(cfg.domain.n_aero)]
        tau_alg = None
        if cfg.zbgc.dEdd_algae and "bgc_N" in trcrn:
            # ice-algal chlorophyll shades the bottom ice layer (chl = N *
            # ratio_chl2N, tau = kalg * chl)
            chla = trcrn["bgc_N"] * cfg.zbgc.ratio_chl2N_diatoms
            tau_alg = cfg.shortwave.kalg * torch.clamp(chla, min=0.0)
        sw = shortwave_dEdd(Tsf, hin, hsn, hpnd_rad, apeff_rad,
                            fc.swvdr, fc.swvdf, fc.swidr, fc.swidf,
                            fc.coszen, cfg.shortwave, nilyr, nslyr,
                            aero_snow=aero_snow,
                            modal_aero=cfg.shortwave.modal_aero,
                            tau_alg=tau_alg)
    else:
        sw = shortwave_ccsm3(Tsf, hin, hsn, fc.swvdr, fc.swvdf, fc.swidr,
                             fc.swidf, cfg.shortwave, nilyr)

    # turbulent transfer coefficients
    if cfg.forcing.atmbndy == "constant":
        co = atmo_boundary_const(Tsf, fc.uatm, fc.vatm, fc.wind, fc.rhoa,
                                 fc.Qa)
    else:
        Cdn = None
        if cfg.forcing.formdrag:
            Cdn = drag_from_state(state, cfg).Cdn_atm
        ua, va, wnd = fc.uatm, fc.vatm, fc.wind
        if cfg.forcing.highfreq:
            # high-frequency coupling: the boundary layer sees the wind
            # relative to the moving ice
            ua = ua - grid_average_X2Y("S", state.uvel, "U", "T", grid)
            va = va - grid_average_X2Y("S", state.vvel, "U", "T", grid)
            wnd = torch.sqrt(ua * ua + va * va)
        co = atmo_boundary_layer(Tsf, fc.potT, ua, va, wnd,
                                 fc.zlvl, fc.Qa, fc.rhoa,
                                 natmiter=cfg.forcing.natmiter, Cdn_atm=Cdn,
                                 atmiter_conv=cfg.forcing.atmiter_conv)

    hin_solve = torch.clamp(hin, min=cfg.thermo.hi_min)
    hilyr = hin_solve / nilyr
    hslyr = hsn / nslyr
    Isw = [sw.Iswabs[:, k] for k in range(nilyr)]
    if mushy:
        sice_all = trcrn["sice"]              # (ncat, nilyr, ny, nx)
        S_lay = [torch.where(mask, sice_all[:, k], float(salin[k]))
                 for k in range(nilyr)]
        salin_arg = S_lay
        Tm_arg = [mush.liquidus_temperature(S) for S in S_lay]
        # congel_freeze='one-step' freezes congelation ice solid at once
        # (phi_init -> 1); 'two-step' forms mush at phi_i_mushy
        phi_new = (1.0 if cfg.thermo.congel_freeze == "one-step"
                   else cfg.thermo.phi_i_mushy)
        qbot_new, S_bot_new = mush.new_ice_enthalpy_salinity(
            Tbot, fc.sss, phi_new)
    else:
        salin_arg = [float(x) for x in salin]
        Tm_arg = [float(x) for x in Tmlt]
        qbot_new = None

    ts, qsno_new, qice_new = temperature_changes(
        dt, nilyr, nslyr, Tsf=Tsf, qsno=qsno, qice=qice,
        salin=salin_arg, Tm=Tm_arg,
        hilyr=hilyr, hslyr=hslyr, Tbot=Tbot, fswsfc=sw.fswsfc,
        Iswabs=Isw, shcoef=co.shcoef, lhcoef=co.lhcoef,
        potT=fc.potT, Qa=fc.Qa, rhoa=fc.rhoa, flw=fc.flw,
        conduct=cfg.thermo.conduct, nit=cfg.thermo.nit,
        ktherm=cfg.thermo.ktherm, mesh=tile_mesh(grid.bc))

    th, dzi, dzs = thickness_changes(
        dt, nilyr, nslyr, hin=hin_solve * mask_f,
        hsn=hsn, qice=qice_new, qsno=qsno_new,
        Tm=Tm_arg, salin=salin_arg,
        Tbot=Tbot, fbot=fbot, fsurf=ts.fsurf, fcondtop=ts.fcondtop,
        fcondbot=ts.fcondbot, flat=ts.flat, sss=fc.sss,
        qbot_new=qbot_new,
        saltflux_option=(cfg.thermo.saltflux_option if mushy
                         else "constant"),
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
    if mushy:
        # bottom congelation carries the new-ice salinity into the bottom
        # layer, then the remap and two-mode gravity drainage
        S_mix = list(S_lay)
        S_mix[-1] = safe_mix(S_mix[-1], hilyr, S_bot_new, th.congel)
        sice_r = adjust_enthalpy(dzi, S_mix, nilyr, th.hin)
        T_r = [mush.temperature_mush(qice_r[k], sice_r[k])
               for k in range(nilyr)]
        sice_r, fsalt_d = mush.drain_salinity(
            cfg.thermo, dt, S_layers=sice_r, T_layers=T_r,
            hilyr=th.hin / nilyr, sss=fc.sss, nilyr=nilyr)
        trcrn["sice"] = torch.stack(
            [torch.where(mask, x, sice_all[:, k])
             for k, x in enumerate(sice_r)], dim=1)
        # drained brine salt reaches the ocean (category-area weighted)
        fsalt_drain = lsum(torch.where(mask, an, 0.0) * fsalt_d, dim=0)

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

    # aerosol and isotope tracers, the brine height and the z tracers
    trcrn, bgc_fluxes = _therm1_bgc(cfg, trcrn, fc, dt, an=an,
                                    vicen=vicen_out, vsnon=vsnon_out, th=th,
                                    sw=sw, aice=aice, timer=timer)

    # advanced snow physics (icepack_step_snow; it rides with therm1, where
    # the per-category melt and snow temperature are in hand)
    fsloss_n = None
    meltsliq = None
    if cfg.tracers.tr_snow:
        trcrn, meltsliq, vsnon_out, fsloss_n = step_snow(
            cfg, dt, vsnon=vsnon_out, aicen=an, trcrn=trcrn,
            Tsno=temp_from_enthalpy_snow(trcrn["qsno"][:, 0]),
            melts=th.melts, frain=fc.frain, fsnow=fc.fsnow, wind=fc.wind)

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
        meltsliq=zero2 if meltsliq is None else ws(meltsliq),
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
    agg["ncat_fluxes"]["fsloss"] = (zero2 if fsloss_n is None
                                    else lsum(fsloss_n, dim=0))
    # the z network's interior diagnostics and the fluxes to the ocean of
    # the z tracers, aerosols (coupler Fioi_bcpho/bcphi/flxdst) and
    # isotopes
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


def _en_stress_splits(prepc, extra, uvelE, vvelE, uvelN, vvelN):
    """The E/N-point momentum-balance splits for history (the reference's
    strair*/strcor*/strtlt* E/N fields). The prep folds air stress and the
    geostrophic tilt into forcexE/forceyN: unfold them here, and take the
    Coriolis terms at the final velocities. `extra` (CD only) gives the
    cross-component forcings."""
    fmE, fmN = prepc.fmE, prepc.fmN
    out = {
        "strairxE": prepc.forcexE + fmE * prepc.vocnE,
        "strtltxE": -fmE * prepc.vocnE,
        "strairyN": prepc.forceyN - fmN * prepc.uocnN,
        "strtltyN": fmN * prepc.uocnN,
        "strcorxE": fmE * vvelE,
        "strcoryN": -fmN * uvelN,
    }
    if extra is not None:
        out.update({
            "strairyE": extra.forceyE - fmE * prepc.uocnE,
            "strtltyE": fmE * prepc.uocnE,
            "strcoryE": -fmE * uvelE,
            "strairxN": extra.forcexN + fmN * prepc.vocnN,
            "strtltxN": -fmN * prepc.vocnN,
            "strcorxN": fmN * vvelN,
        })
    return out


def _step_dyn_c(cfg, grid: Grid, state: State, fc: Forcing, strairx_T,
                strairy_T, dt: float, p, strength, mesh=None):
    """The C and CD grids' EVP (kdyn=1): face velocities, the stress state
    in slot 0 (T points) and slot 1 (U points, CD only) of the 4-corner
    arrays, the U-point exports and the native E/N planes. On the C grid
    evp_algorithm='wide_halo' runs the wide-halo solve on `mesh`."""
    d = cfg.dynamics
    prepc = evp_c.dyn_prep_c(grid, d, dt, aice=state.aice, vice=state.vice,
                             vsno=state.vsno, uvelE=state.uvelE,
                             vvelN=state.vvelN, strairxT=strairx_T,
                             strairyT=strairy_T, uocn_T=fc.uocn,
                             vocn_T=fc.vocn)
    if cfg.grid.grid_ice == "CD":
        extra = evp_c.dyn_prep_cd(grid, d, dt, prepc, vvelE=state.vvelE,
                                  uvelN=state.uvelN, strairxT=strairx_T,
                                  strairyT=strairy_T)
        m = prepc.iceTmask
        init = evp_c.CDEvpState(
            uvelE=prepc.uvelE_init, vvelE=extra.vvelE_init,
            uvelN=extra.uvelN_init, vvelN=prepc.vvelN_init,
            stresspT=torch.where(m, state.stressp[0], 0.0),
            stressmT=torch.where(m, state.stressm[0], 0.0),
            stress12T=torch.where(m, state.stress12[0], 0.0),
            stresspU=state.stressp[1], stressmU=state.stressm[1],
            stress12U=state.stress12[1])
        fin, uU, vU = evp_c.evp_cd_solve(grid, p, prepc, extra, strength,
                                         init)
        slots = {"stressp": (fin.stresspT, fin.stresspU),
                 "stressm": (fin.stressmT, fin.stressmU),
                 "stress12": (fin.stress12T, fin.stress12U)}
        vvelE, uvelN = fin.vvelE, fin.uvelN
        faces = dict(vvelE=vvelE, uvelN=uvelN)
    else:
        extra = None
        if d.evp_algorithm == "wide_halo":
            from ..parallel.evp_wide import evp_c_solve_wide
            fin, uU, vU = evp_c_solve_wide(
                grid, p, prepc, strength, state.stressp[0],
                state.stressm[0], state.stress12[0], mesh=mesh,
                k_fuse=d.evp_wide_k)
        else:
            fin, uU, vU = evp_c.evp_c_solve(grid, p, prepc, strength,
                                            state.stressp[0],
                                            state.stressm[0],
                                            state.stress12[0])
        slots = {"stressp": (fin.stresspT,), "stressm": (fin.stressmT,),
                 "stress12": (fin.stress12U,)}
        vvelE = grid_average_X2Y("S", fin.vvelN, "N", "E", grid)
        uvelN = grid_average_X2Y("S", fin.uvelE, "E", "N", grid)
        faces = {}
    stresses = {}
    for k, new in slots.items():
        st = getattr(state, k).clone()
        for slot, plane in enumerate(new):
            st[slot] = plane
        stresses[k] = st
    divu, shear, Delta = evp_c.deformations_C(grid, fin.uvelE, fin.vvelN, p)
    state = state.replace(uvel=uU, vvel=vU, uvelE=fin.uvelE,
                          vvelN=fin.vvelN, **faces, **stresses)
    fin_d = evp_c.c_dyn_finish(grid, prepc, fin.uvelE, fin.vvelN,
                               fin.stresspT, fin.stressmT, fin.stress12U,
                               **faces)
    diags = {k: fin_d[k] for k in ("strintx", "strinty", "taubx", "tauby",
                                   "strocnx", "strocny")}
    diags.update(divu=divu, shear=shear, Delta=Delta, strength=strength)
    diags.update({k: fin_d[k] for k in evp_c.EN_PLANES})
    if extra is not None:
        diags.update(evp_c.cd_cross_planes(grid, prepc, fin))
    diags.update(_en_stress_splits(prepc, extra, fin.uvelE, vvelE, uvelN,
                                   fin.vvelN))
    return state, diags


def b_grid_prep(cfg, grid: Grid, state: State, fc: Forcing, strairx_T,
                strairy_T, dt: float):
    """(prep, uocnU, vocnU): what the B-grid solvers of step_dyn_horiz take
    besides the strength and the stresses. With form drag the ocean drag
    coefficient at U points comes from the state (floored at 1e-4)."""
    CwU = None
    if cfg.forcing.formdrag:
        dragc = drag_from_state(state, cfg)
        CwU = torch.clamp(grid_average_X2Y("S", dragc.Cdn_ocn, "T", "U",
                                           grid), min=1e-4)
    prep = dyn_prep(grid, cfg.dynamics, dt, aice=state.aice,
                    vice=state.vice, vsno=state.vsno,
                    aiceU_prev_mask=state.iceUmask, uvel=state.uvel,
                    vvel=state.vvel, strairxT=strairx_T,
                    strairyT=strairy_T, uocn_T=fc.uocn, vocn_T=fc.vocn,
                    ss_tltx_T=fc.ss_tltx, ss_tlty_T=fc.ss_tlty, Cw_in=CwU)
    return (prep, grid_average_X2Y("S", fc.uocn, "T", "U", grid),
            grid_average_X2Y("S", fc.vocn, "T", "U", grid))


def step_dyn_horiz(ms: ModelStatic, grid: Grid, state: State, fc: Forcing,
                   strairx_T, strairy_T, dt: float):
    """Horizontal dynamics (reference step_dyn_horiz:969), in the JAX
    package's order of dispatch: on a C or CD grid, kdyn=1 runs the
    C-grid EVP (dynamics/evp_c.py); then on the B grid kdyn=3 the implicit
    VP solver, kdyn=2 EAP, and kdyn=1 the EVP algorithm. `evp_algorithm`
    chooses the EVP solver: 'fused_pallas' runs the fused CUDA EVP kernel
    (kernels/evp.py; its plain version on CPU tensors), 'standard_2d' the
    plain PyTorch loop, and 'wide_halo' the wide-halo solve across the
    ranks of `ms.mesh` (parallel/evp_wide.py; without a mesh the one-program
    solve, as in the JAX package, through the fused kernel as
    'fused_pallas'). On a C grid 'wide_halo' runs the C-grid
    wide-halo solve and the others `evp_c_solve`, as in the JAX package
    (no kernel computes the C-grid EVP, so this is not a fallback); the
    CD grid always runs `evp_cd_solve`."""
    cfg = ms.cfg
    d = cfg.dynamics
    p = evp_params(d, dt)
    tiled = isinstance(grid.bc, TileBC)
    strength = ice_strength(state.aicen, state.vicen, state.aice, state.vice,
                            d)
    if cfg.grid.grid_ice in ("C", "CD"):
        check_ported(cfg)    # EAP and VP are B-grid solvers
        return _step_dyn_c(cfg, grid, state, fc, strairx_T, strairy_T, dt,
                           p, strength, mesh=ms.mesh)
    prep, uocnU, vocnU = b_grid_prep(cfg, grid, state, fc, strairx_T,
                                     strairy_T, dt)

    extra_diags = {}
    if d.kdyn == 3:
        u, v, sp, sm, s12, strintx, strinty, taubx, tauby, _ = \
            implicit_solver(grid, d, prep, strength, uocn=uocnU,
                            vocn=vocnU, dt=dt)
    elif d.kdyn == 2:
        solve, kw = eap_solve, {}
        if tiled:
            from ..parallel.evp_wide import eap_solve_wide
            solve, kw = eap_solve_wide, dict(k_fuse=d.evp_wide_k)
        (u, v, sp, sm, s12, strintx, strinty, taubx, tauby, a11, a12,
         extra_diags) = solve(grid, p, prep, strength, state.stressp,
                              state.stressm, state.stress12, uocn=uocnU,
                              vocn=vocnU, a11=state.a11, a12=state.a12, **kw)
        state = state.replace(a11=a11, a12=a12)
    else:
        kw = {}
        if tiled and d.evp_algorithm in ("fused_pallas", "wide_halo"):
            # on tiles the fused kernel runs as the wide-halo solve: K1 on
            # each rank's padded tile, k subcycles per halo exchange
            from ..parallel.evp_wide import evp_solve_wide
            solve = evp_solve_wide
            kw = dict(mesh=grid.bc.mesh, k_fuse=d.evp_wide_k)
        elif d.evp_algorithm == "fused_pallas":
            from ..kernels.evp import evp_solve_fused
            solve = evp_solve_fused
        elif d.evp_algorithm == "wide_halo":
            from ..parallel.evp_wide import evp_solve_wide
            solve = evp_solve_wide
            kw = dict(mesh=ms.mesh, k_fuse=d.evp_wide_k)
        else:
            solve = evp_solve
        u, v, sp, sm, s12, strintx, strinty, taubx, tauby = solve(
            grid, p, prep, strength, state.stressp, state.stressm,
            state.stress12, uocn=uocnU, vocn=vocnU, **kw)

    strocnx, strocny = evp_ocean_stress(prep, u, v, uocnU, vocnU)
    divu, shear, Delta = deformations_B(grid, u, v, p, dt)
    state = state.replace(uvel=u, vvel=v, stressp=sp, stressm=sm,
                          stress12=s12, iceUmask=prep.iceUmask)
    dyn_diags = dict(strintx=strintx, strinty=strinty, taubx=taubx,
                     tauby=tauby, strocnx=strocnx, strocny=strocny,
                     divu=divu, shear=shear, Delta=Delta, strength=strength,
                     **extra_diags)
    return state, dyn_diags


def resolve_remap_kernel(cfg, grid: Grid, dtype: torch.dtype) -> str:
    """The transport engine for remap_kernel='auto': the one-pass CUDA
    kernel (K2, 'fused_full') on a CUDA device with f32 state and neither
    tripole nor y-cyclic boundaries, else the plain path (the JAX
    package's 'xla'). Unlike the JAX package (its model/step.py:806-826),
    there is no 'fused_pallas' fallback for tables too large for the
    one-pass kernel. The JAX package needs it where the TPU's VMEM runs
    out; K2 holds a chunk of its schedule in shared memory, not the table,
    and finds a tile for tables of thousands of tracers
    (tests/test_torch_remap_chunks.py: 3005)."""
    fk = cfg.dynamics.remap_kernel
    if fk != "auto":
        return fk
    if (grid.device.type == "cuda" and dtype == torch.float32
            and not grid.bc.tripole and not grid.bc.y_cyclic):
        return "fused_full"
    return "xla"


def step_dyn_transport(ms: ModelStatic, grid: Grid, state: State,
                       fc: Forcing, strairx_T, strairy_T, dt: float,
                       timer=None):
    """The ndtd dynamics/transport/ridging supercycle of one thermo step
    (the `do k=1,ndtd` loop of CICE_RunMod.F90:287-322). Returns (state,
    dyn_diags, tchecks): the last sub-step's dynamics and ridging
    diagnostics, with the ridging cleanup losses to the ocean summed
    dt-weighted over sub-steps under `fresh_cleanup`, `fsalt_cleanup`,
    `fhocn_cleanup`, and the transport checks merged over sub-steps (flags
    or-ed, errors max-ed)."""
    cfg = ms.cfg
    tchecks: dict = {}
    z = torch.zeros(grid.shape, dtype=state.aicen.dtype,
                    device=state.aicen.device)
    clean = {k: z for k in _CLEANUP_KEYS}
    if cfg.dynamics.kdyn < 1:
        dyn = {k: z for k in ("strocnx", "strocny", "divu", "shear", "Delta",
                              "strintx", "strinty", "taubx", "tauby",
                              "strength")}
        dyn.update({f"{k}_cleanup": v for k, v in clean.items()})
        return state, dyn, tchecks
    hin_max = ms.hin_max
    ndtd = max(cfg.setup.ndtd, 1)
    dt_dyn = dt / ndtd
    for _ in range(ndtd):
        with _phase(timer, "dyn"):
            state, dyn = step_dyn_horiz(ms, grid, state, fc, strairx_T,
                                        strairy_T, dt_dyn)
        advection = cfg.dynamics.advection
        if cfg.dynamics.ktransport >= 1 and advection in ADVECT:
            with _phase(timer, "transport"):
                state = ADVECT[advection](grid, state, ms.registry, fc.Tf,
                                          dt_dyn,
                                          grid_ice=cfg.grid.grid_ice)
        elif cfg.dynamics.ktransport >= 1 and advection == "remap":
            from ..dynamics.remap_exact import horizontal_remap_exact
            fk = resolve_remap_kernel(cfg, grid, state.aicen.dtype)
            with _phase(timer, "transport"):
                state, td = horizontal_remap_exact(
                    grid, state, ms.registry, fc.Tf, dt_dyn,
                    grid_ice=cfg.grid.grid_ice,
                    l_dp_midpt=cfg.dynamics.l_dp_midpt,
                    conserv_check=cfg.setup.conserv_check,
                    monotonicity_check=cfg.dynamics.monotonicity_check,
                    flux_kernel=fk)
            for k, v in td.items():
                prev = tchecks.get(k)
                tchecks[k] = v if prev is None else \
                    (prev | v if v.dtype == torch.bool
                     else torch.maximum(prev, v))
        if cfg.dynamics.kridge >= 1:
            with _phase(timer, "ridge"):
                aicen, vicen, vsnon, trcrn, rdg = ridge_ice(
                    cfg, state.aicen, state.vicen, state.vsnon, state.trcrn,
                    divu=dyn["divu"], Delta=dyn["Delta"], dt=dt_dyn,
                    hin_max=hin_max, registry=ms.registry,
                    mesh=tile_mesh(grid.bc))
            state = state.replace(aicen=aicen, vicen=vicen, vsnon=vsnon,
                                  trcrn=trcrn)
            for k in _CLEANUP_KEYS:
                # dt-weighted: cleanup rates are per dt_dyn sub-step
                clean[k] = clean[k] + rdg.pop(f"{k}_cleanup") * \
                    (dt_dyn / dt)
            dyn.update(rdg)
    dyn.update({f"{k}_cleanup": v for k, v in clean.items()})
    return state, dyn, tchecks


# ---------------------------------------------------------------------------
# the full model step
# ---------------------------------------------------------------------------

#: the wave_spec_type values whose spectrum the FSD fracture reads (under
#: 'file' it takes Hs and Tp only, as in the JAX package)
_SPECTRUM_TYPES = ("profile", "constant", "random")


def _step_fsd(cfg, state: State, fc: Forcing, aicen_pre, t2, dt: float):
    """The FSD after step_therm2: new ice, lateral growth/melt and welding
    (step_fsd_thermo), then wave fracture (step_dyn_wave). Returns (state,
    the dafsd_* tendencies)."""
    trc = dict(state.trcrn)
    da_new = torch.clamp(t2.aicen - aicen_pre, min=0.0)
    G_rad = torch.sign(state.frzmlt) * torch.abs(state.frzmlt) * 1.0e-8
    f, tend = step_fsd_thermo(cfg, dt, fsd=trc["fsd"], aicen=t2.aicen,
                              da_new=da_new, G_rad=G_rad[None],
                              frzmlt=state.frzmlt, return_tend=True)
    spectrum = (fc.wave_spectrum
                if cfg.forcing.wave_spec_type in _SPECTRUM_TYPES else None)
    f, wtend = step_dyn_wave(cfg, dt, fsd=f, aicen=t2.aicen, vicen=t2.vicen,
                             hs_wave=fc.wave_hs, Tp_wave=fc.wave_Tp,
                             wave_spectrum=spectrum, return_tend=True)
    tend.update(wtend)
    trc["fsd"] = f
    return state.replace(trcrn=trc), tend


def _step_bgc_skl(cfg, state: State, fc: Forcing, agg: dict, dt: float):
    """The skeletal-layer network after step_therm2 (reference
    biogeochemistry phase, ice_step_mod.F90:1634), driven by the
    ice-area means of therm1's bottom fluxes. Adds the fluxes to the ocean
    (fbgc_*), grow_net, upNO, upNH and PP_net to agg['ncat_fluxes'] and
    returns the state."""
    trc = dict(state.trcrn)
    bgc_keys = [k for k in trc if k.startswith("bgc_")]
    aice_safe = torch.clamp(state.aice, min=cst.puny)
    z = cfg.zbgc
    ocean = {"bgc_Nit": z.nit_data, "bgc_Am": z.amm_data,
             "bgc_Sil": z.sil_data, "bgc_DMSPd": z.dms_data,
             "bgc_DMS": z.dms_data, "bgc_DON": 0.0,
             "bgc_hum": z.hum_data,
             "bgc_Fed": z.fed_data, "bgc_Fed2": z.fed_data,
             **{f"bgc_DOC{i+1}": z.doc_data for i in range(z.n_doc)},
             **{f"bgc_DIC{i+1}": z.dic_data for i in range(z.n_dic)}}
    bout = step_bgc_skl_net(
        z, dt, aicen=state.aicen, trc={k: trc[k] for k in bgc_keys},
        fswthru=(agg["fswthru"] / aice_safe)[None],
        Tbot=fc.Tf[None], meltb=(agg["meltb"] / aice_safe)[None],
        congel=(agg["congel"] / aice_safe)[None], ocean=ocean)
    trc.update(bout.trc)
    nf = agg["ncat_fluxes"]
    nf.update({f"fbgc_{k[4:]}": v for k, v in bout.flux_bgc_ocn.items()})
    nf["grow_net"] = lsum(bout.grow_net * state.aicen, dim=0) / \
        aice_safe
    for nm, v in (("upNO", bout.upNO), ("upNH", bout.upNH),
                  ("PP_net", bout.PP_net)):
        nf[nm] = lsum(v * state.aicen, dim=0)
    return state.replace(trcrn=trc)


def _mean_age(st: State):
    if "iage" not in st.trcrn:
        return torch.zeros_like(st.aice)
    return lsum(st.trcrn["iage"] * st.aicen, dim=0) / \
        torch.clamp(st.aice, min=cst.puny)


def model_step(ms: ModelStatic, grid: Grid, state: State, fc: Forcing,
               dt: float, timer=None):
    """One full thermo+dyn timestep. Returns (state, FluxOut). `timer`, if
    given, is called with a phase name ('therm1', 'zbgc' inside therm1
    under z_tracers, 'therm2', 'fsd' under tr_fsd, 'bgc' under skl_bgc,
    'dyn', 'transport', 'ridge', 'ocean') and returns a context manager
    that the phase runs in. While a profiler runs, each phase opens the
    range "ice:<phase>" inside the timer's context, and the code before
    therm1, between the thermo phases and the dynamics, and after ocean
    "ice:prep", "ice:tendencies" and "ice:fluxes"."""
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
    with span("ice:prep"):
        pond_mass_pre = pond_reservoir_mass(state.trcrn, state.aicen,
                                            pond_lvl)
        age_init = _mean_age(state)

    # --- thermodynamics -------------------------------------------------
    with _phase(timer, "therm1"):
        state, agg, hicen_old = step_therm1(ms, grid, state, fc, dt,
                                            timer=timer)

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
    aicen_pre = state.aicen
    state = state.replace(aicen=t2.aicen, vicen=t2.vicen, vsnon=t2.vsnon,
                          trcrn=t2.trcrn)

    # FSD: thermodynamic evolution and wave fracture (step_dyn_wave)
    fsd_tend = {}
    if cfg.tracers.tr_fsd and "fsd" in state.trcrn:
        with _phase(timer, "fsd"):
            state, fsd_tend = _step_fsd(cfg, state, fc, aicen_pre, t2, dt)

    # skeletal-layer biogeochemistry
    if cfg.zbgc.skl_bgc and "bgc_N" in state.trcrn:
        with _phase(timer, "bgc"):
            state = _step_bgc_skl(cfg, state, fc, agg, dt)

    # pond reservoir change over the thermo phases: positive = water
    # retained on the ice, deducted from the coupler fresh flux. Rain over
    # ice enters the ice system here; the uncaptured remainder runs off
    with span("ice:tendencies"):
        pond_mass_post = pond_reservoir_mass(state.trcrn, state.aicen,
                                             pond_lvl)
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
    with span("ice:fluxes"):
        # melt/freeze onset day-of-year (Model.step resets them yearly)
        mlt_onset = torch.where(
            (state.mlt_onset <= 0.0) & (agg["meltt"] > 0.0), fc.yday,
            state.mlt_onset)
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
            ncat_fluxes={**agg["ncat_fluxes"], **fsd_tend,
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
