"""History field registry (PyTorch port of the registry half of
cice_tpu/io/history.py; reference ice_history.F90 `init_hist` field
registration honoring the icefields_nml flags, ice_history_shared.F90
`define_hist_field`:918).

A `HistoryField` names a diagnostic and an extractor over (state, flux,
grid[, forcing]) that returns its planes as tensors on the model's device.
`build_fields(cfg)` gives the registry in the JAX package's order, so the
names, units, dimensions and rows of the two packages' history files agree.

The groups whose physics is not ported yet (snow, fsd, bgc, zbgc, hbrine,
drag, aerosols and isotopes, and the mushy branches of the profile and
CMIP temperatures) raise `NotImplementedError` naming ROADMAP A6 when the
configuration enables them; they never write zeros in place of a field.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from .. import constants as cst
from ..core.grid import grid_average_X2Y
from ..core.halo import shift


@dataclass(frozen=True)
class HistoryField:
    name: str
    units: str
    long_name: str
    extract: Callable          # (state, flux, grid[, forcing]) -> (ny, nx)
    cell_mask: bool = True     # apply ocean mask on write
    needs_forcing: bool = False  # extract takes a 4th `forcing` argument
    # stream-frequency chars this field belongs to (reference icefields_nml
    # per-field flags, f_aice='md'): None = every configured stream; 'x' =
    # disabled; otherwise e.g. 'm', 'd1'. Set from cfg.setup.hist_field_freq.
    freq: Optional[str] = None
    # write the last value instead of the stream average even on averaging
    # streams (reference f_aisnap/f_hisnap snapshot fields)
    snapshot: bool = False
    # extra leading axes before (nj, ni): the reference's 3Dc/3Dz/4Di/4Ds
    # axis system (ice_history_shared.F90:101-123) as ((dim_name, size),
    # ...); extract returns shape (*sizes, ny, nx) and the writers emit one
    # variable on these dims with coordinate variables (NCAT, VGRDi, ...)
    dims: Tuple = ()


def nrows(f: HistoryField) -> int:
    """Rows of the stacked accumulator the field occupies."""
    n = 1
    for _d, sz in f.dims:
        n *= sz
    return n


def _f(name, units, long_name, fn, dims=()):
    return HistoryField(name, units, long_name, fn, dims=dims)


def _ff(name, units, long_name, fn):
    """Field sourced from the atmosphere/ocean forcing (f_Tair, f_uatm, ...)."""
    return HistoryField(name, units, long_name, fn, needs_forcing=True)


def _mx(x, lo):
    return torch.clamp(x, min=lo)


def _agg(catfield, aicen, aice):
    return (catfield * aicen).sum(0) / _mx(aice, cst.puny)


def _flag(cond, like):
    """1.0 where cond holds, else 0.0, in `like`'s dtype."""
    return cond.to(like.dtype)


def _deg_mod(y, x):
    """atan2(y, x) in degrees, in [0, 360)."""
    return torch.remainder(torch.rad2deg(torch.atan2(y, x)), 360.0)


def _nf2d(key):
    """2-D plane from flux.ncat_fluxes (zeros when absent)."""
    def fn(s, fl, g):
        v = fl.ncat_fluxes.get(key)
        return torch.zeros_like(s.aice) if v is None else v
    return fn


def _cat3(key, ncat):
    """3Dc extractor over the per-category flux diagnostics dict."""
    def fn(s, fl, g):
        planes = fl.ncat_fluxes.get(key)
        if planes is None:
            return torch.zeros((ncat,) + tuple(s.aice.shape),
                               dtype=s.aice.dtype, device=s.aice.device)
        return planes
    return fn


def _mass(s):
    return cst.rhoi * s.vice + cst.rhos * s.vsno


def _fcor(g):
    return 2.0 * cst.omega * torch.sin(g.ULAT)


def default_fields() -> List[HistoryField]:
    """The core 2-D field set (names follow ice_history's f_* conventions)."""
    return [
        _f("aice", "1", "ice area (aggregate)", lambda s, fl, g: s.aice),
        _f("hi", "m", "grid cell mean ice thickness", lambda s, fl, g: s.vice),
        _f("hs", "m", "grid cell mean snow thickness", lambda s, fl, g: s.vsno),
        _f("Tsfc", "C", "snow/ice surface temperature",
           lambda s, fl, g: _agg(s.trcrn["Tsfcn"], s.aicen, s.aice)),
        _f("uvel", "m/s", "ice velocity (x)", lambda s, fl, g: s.uvel),
        _f("vvel", "m/s", "ice velocity (y)", lambda s, fl, g: s.vvel),
        _f("sst", "C", "sea surface temperature", lambda s, fl, g: s.sst),
        _f("frzmlt", "W/m^2", "freeze/melt potential", lambda s, fl, g: s.frzmlt),
        _f("fsens", "W/m^2", "sensible heat flux", lambda s, fl, g: fl.fsens),
        _f("flat", "W/m^2", "latent heat flux", lambda s, fl, g: fl.flat),
        _f("flwout", "W/m^2", "outgoing longwave", lambda s, fl, g: fl.flwout),
        _f("fswabs", "W/m^2", "absorbed shortwave", lambda s, fl, g: fl.fswabs),
        _f("fswthru", "W/m^2", "SW through ice to ocean", lambda s, fl, g: fl.fswthru),
        _f("fhocn", "W/m^2", "heat flux to ocean", lambda s, fl, g: fl.fhocn),
        _f("fresh", "kg/m^2/s", "fresh water flux to ocean", lambda s, fl, g: fl.fresh),
        _f("fsalt", "kg/m^2/s", "salt flux to ocean", lambda s, fl, g: fl.fsalt),
        _f("meltt", "m/step", "top ice melt", lambda s, fl, g: fl.meltt),
        _f("meltb", "m/step", "bottom ice melt", lambda s, fl, g: fl.meltb),
        _f("melts", "m/step", "snow melt", lambda s, fl, g: fl.melts),
        _f("meltl", "m/step", "lateral ice melt", lambda s, fl, g: fl.meltl),
        _f("congel", "m/step", "congelation growth", lambda s, fl, g: fl.congel),
        _f("frazil", "m/step", "frazil growth", lambda s, fl, g: fl.frazil),
        _f("snoice", "m/step", "snow-ice formation", lambda s, fl, g: fl.snoice),
        _f("strairx", "N/m^2", "atm/ice stress (x)", lambda s, fl, g: fl.strairx),
        _f("strocnx", "N/m^2", "ocean/ice stress (x)", lambda s, fl, g: fl.strocnx),
        _f("albsni", "1", "snow/ice broadband albedo",
           lambda s, fl, g: (fl.alvdr * cst.awtvdr + fl.alidr * cst.awtidr +
                             fl.alvdf * cst.awtvdf + fl.alidf * cst.awtidf)),
        # snapshot fields: last value written even on averaging streams
        # (reference f_aisnap/f_hisnap, ice_history.F90)
        HistoryField("aisnap", "1", "ice area snapshot",
                     lambda s, fl, g: s.aice, snapshot=True),
        HistoryField("hisnap", "m", "ice volume snapshot",
                     lambda s, fl, g: s.vice, snapshot=True),
    ]


def cmip_fields() -> List[HistoryField]:
    """CMIP-standard alias fields (reference f_si* registrations in
    ice_history.F90 / icefields_nml: siconc, sithick, sisnthick, simass,
    sisnmass, siu, siv, sispeed, sitemptop, sitimefrac)."""
    return [
        _f("siconc", "1", "sea-ice area fraction (CMIP)",
           lambda s, fl, g: s.aice),
        _f("sithick", "m", "sea-ice thickness (CMIP)",
           lambda s, fl, g: s.vice / _mx(s.aice, cst.puny)),
        _f("sisnthick", "m", "snow thickness (CMIP)",
           lambda s, fl, g: s.vsno / _mx(s.aice, cst.puny)),
        _f("simass", "kg/m^2", "sea-ice mass per area (CMIP)",
           lambda s, fl, g: cst.rhoi * s.vice),
        _f("sisnmass", "kg/m^2", "snow mass per area (CMIP)",
           lambda s, fl, g: cst.rhos * s.vsno),
        _f("siu", "m/s", "sea-ice x velocity (CMIP)",
           lambda s, fl, g: s.uvel),
        _f("siv", "m/s", "sea-ice y velocity (CMIP)",
           lambda s, fl, g: s.vvel),
        _f("sispeed", "m/s", "sea-ice speed (CMIP)",
           lambda s, fl, g: torch.sqrt(s.uvel ** 2 + s.vvel ** 2)),
        _f("sitemptop", "C", "sea-ice surface temperature (CMIP)",
           lambda s, fl, g: _agg(s.trcrn["Tsfcn"], s.aicen, s.aice)),
        _f("sitimefrac", "1", "time fraction with ice present (CMIP)",
           lambda s, fl, g: _flag(s.aice > cst.puny, s.aice)),
    ]


def pond_fields() -> List[HistoryField]:
    """Melt-pond group (ice_history_pond.F90: apond/hpond/ipond...)."""
    def apond(s, fl, g):
        apnd = s.trcrn["apnd"]
        lvl = s.trcrn.get("alvl", torch.ones_like(apnd))
        return (apnd * torch.clamp(lvl, 0, 1) * s.aicen).sum(0)
    return [
        _f("apond", "1", "melt pond fraction of grid cell", apond),
        _f("hpond", "m", "mean melt pond depth",
           lambda s, fl, g: _agg(s.trcrn["hpnd"], s.aicen, s.aice)),
        _f("ipond", "m", "mean pond ice lid thickness",
           lambda s, fl, g: _agg(s.trcrn["ipnd"], s.aicen, s.aice)),
    ]


def mechred_fields() -> List[HistoryField]:
    """Mechanical-redistribution group (ice_history_mechred.F90:
    ardg/vrdg ridged area & volume from the level-ice tracers)."""
    return [
        _f("ardg", "1", "ridged ice area fraction",
           lambda s, fl, g: ((1.0 - torch.clamp(s.trcrn["alvl"], 0, 1))
                             * s.aicen).sum(0)),
        _f("vrdg", "m", "ridged ice volume per area",
           lambda s, fl, g: ((1.0 - torch.clamp(s.trcrn["vlvl"], 0, 1))
                             * s.vicen).sum(0)),
    ]


def age_fields() -> List[HistoryField]:
    return [
        _f("iage", "years", "sea ice age",
           lambda s, fl, g: _agg(s.trcrn["iage"], s.aicen, s.aice) /
           (365.0 * 86400.0)),
        _f("FYarea", "1", "first-year ice area",
           lambda s, fl, g: (s.trcrn["FY"] * s.aicen).sum(0)),
        # age tendencies (reference f_dagedtt/f_dagedtd, years/day)
        _f("dagedtt", "year/day", "ice age tendency, thermo",
           lambda s, fl, g: fl.dagedtt * cst.secday / (365.0 * cst.secday)),
        _f("dagedtd", "year/day", "ice age tendency, dynamics",
           lambda s, fl, g: fl.dagedtd * cst.secday / (365.0 * cst.secday)),
    ]


def dyn_fields() -> List[HistoryField]:
    """Dynamics diagnostics (f_divu/f_shear/f_sig1/f_sig2/f_strength/
    f_strint*/f_taub* in icefields_nml)."""
    def _princ(s, fl, g, which):
        # normalized principal stresses sig1/sig2 (principal_stress,
        # reference ice_history accum via icepack): corner-mean tensor
        sp = s.stressp.mean(0)
        sm = s.stressm.mean(0)
        s12 = s.stress12.mean(0)
        rad = torch.sqrt((0.5 * sm) ** 2 + s12 ** 2)
        P = _mx(fl.strength, 1e-11)
        v = 0.5 * sp + (rad if which == 1 else -rad)
        return torch.where(fl.strength > 1e-11, v / P, 0.0)

    def sigP(s, fl, g):
        # internal ice pressure: the replacement pressure recomputed from
        # the final iterate's (strength, Delta) with the EVP capping form
        # P_r = P*Delta/(Delta+deltamin) (reference f_sigP; visc_replpress
        # ice_dyn_shared.F90:2446)
        dmin = 1e-11
        return fl.strength * fl.Delta / (fl.Delta + dmin)

    return [
        _f("sigP", "N/m", "internal ice pressure", sigP),
        _f("divu", "%/day", "strain rate (divergence)",
           lambda s, fl, g: fl.divu * 8.64e6),
        _f("shear", "%/day", "strain rate (shear)",
           lambda s, fl, g: fl.shear * 8.64e6),
        _f("sig1", "1", "norm. principal stress 1",
           lambda s, fl, g: _princ(s, fl, g, 1)),
        _f("sig2", "1", "norm. principal stress 2",
           lambda s, fl, g: _princ(s, fl, g, 2)),
        _f("strength", "N/m", "compressive ice strength",
           lambda s, fl, g: fl.strength),
        _f("strintx", "N/m^2", "internal stress divergence (x)",
           lambda s, fl, g: fl.strintx),
        _f("strinty", "N/m^2", "internal stress divergence (y)",
           lambda s, fl, g: fl.strinty),
        _f("taubx", "N/m^2", "seabed stress (x)", lambda s, fl, g: fl.taubx),
        _f("tauby", "N/m^2", "seabed stress (y)", lambda s, fl, g: fl.tauby),
        _f("strairy", "N/m^2", "atm/ice stress (y)",
           lambda s, fl, g: fl.strairy),
        _f("strocny", "N/m^2", "ocean/ice stress (y)",
           lambda s, fl, g: fl.strocny),
        _f("trsig", "N/m^2", "internal stress tensor trace",
           lambda s, fl, g: 0.25 * s.stressp.sum(0)),
        _f("icepresent", "1", "fraction of time ice present",
           lambda s, fl, g: _flag(s.aice > 1e-11, s.aice)),
        _f("dardg1dt", "%/day", "area rate ridging",
           lambda s, fl, g: fl.dardg1dt * 8.64e6),
        _f("dardg2dt", "%/day", "ridge area formation rate",
           lambda s, fl, g: fl.dardg2dt * 8.64e6),
        _f("dvirdgdt", "cm/day", "volume rate ridged",
           lambda s, fl, g: fl.dvirdgdt * 8.64e6),
        _f("opening", "%/day", "lead opening rate",
           lambda s, fl, g: fl.opening * 8.64e6),
        _f("daidtt", "%/day", "area tendency, thermo",
           lambda s, fl, g: fl.daidtt * 8.64e6),
        _f("dvidtt", "cm/day", "volume tendency, thermo",
           lambda s, fl, g: fl.dvidtt * 8.64e6),
        _f("daidtd", "%/day", "area tendency, dynamics",
           lambda s, fl, g: fl.daidtd * 8.64e6),
        _f("dvidtd", "cm/day", "volume tendency, dynamics",
           lambda s, fl, g: fl.dvidtd * 8.64e6),
        _f("dsnow", "cm/day", "snow depth tendency, thermo",
           lambda s, fl, g: fl.dvsdtt * 8.64e6),
    ]


def forcing_fields() -> List[HistoryField]:
    """Atmosphere/ocean forcing snapshots (f_Tair/f_uatm/.../f_sss)."""
    return [
        _ff("Tair", "C", "air temperature",
            lambda s, fl, g, fc: fc.Tair - 273.15),
        _ff("Qa", "kg/kg", "air specific humidity",
            lambda s, fl, g, fc: fc.Qa),
        _ff("uatm", "m/s", "wind velocity (x)", lambda s, fl, g, fc: fc.uatm),
        _ff("vatm", "m/s", "wind velocity (y)", lambda s, fl, g, fc: fc.vatm),
        _ff("fswdn", "W/m^2", "downward shortwave",
            lambda s, fl, g, fc: fc.swvdr + fc.swvdf + fc.swidr + fc.swidf),
        _ff("flwdn", "W/m^2", "downward longwave", lambda s, fl, g, fc: fc.flw),
        _ff("snow", "kg/m^2/s", "snowfall rate", lambda s, fl, g, fc: fc.fsnow),
        _ff("rain", "kg/m^2/s", "rainfall rate", lambda s, fl, g, fc: fc.frain),
        _ff("uocn", "m/s", "ocean current (x)", lambda s, fl, g, fc: fc.uocn),
        _ff("vocn", "m/s", "ocean current (y)", lambda s, fl, g, fc: fc.vocn),
        _ff("sss", "psu", "sea surface salinity", lambda s, fl, g, fc: fc.sss),
        _ff("coszen", "1", "cosine solar zenith",
            lambda s, fl, g, fc: fc.coszen),
    ]


def flux_extra_fields() -> List[HistoryField]:
    return [
        _f("evap", "kg/m^2/s", "evaporation/sublimation",
           lambda s, fl, g: fl.evap),
        _f("fsurf_ai", "W/m^2", "net surface heat flux",
           lambda s, fl, g: fl.fsurf),
        _f("fcondtop_ai", "W/m^2", "top conductive heat flux",
           lambda s, fl, g: fl.fcondtop),
        _f("alvdr", "1", "visible direct albedo", lambda s, fl, g: fl.alvdr),
        _f("alvdf", "1", "visible diffuse albedo", lambda s, fl, g: fl.alvdf),
        _f("alidr", "1", "near-IR direct albedo", lambda s, fl, g: fl.alidr),
        _f("alidf", "1", "near-IR diffuse albedo", lambda s, fl, g: fl.alidf),
        _f("sice", "psu", "bulk ice salinity",
           lambda s, fl, g: s.trcrn["sice"].mean(1).mean(0)
           if "sice" in s.trcrn else torch.zeros_like(s.aice)),
    ]


def grid_fields() -> List[HistoryField]:
    """Static grid/metric fields (reference f_ANGLE/f_HTN/f_dxt/f_tarea/...;
    written with every file like the reference's gridded history extras)."""
    deg = cst.rad_to_deg

    def gf(name, units, long_name, attr, scale=1.0, mask=False):
        return HistoryField(name, units, long_name,
                            lambda s, fl, g: getattr(g, attr) * scale,
                            cell_mask=mask)

    return [
        gf("ULAT", "degrees_north", "U-point latitude", "ULAT", deg),
        gf("ULON", "degrees_east", "U-point longitude", "ULON", deg),
        gf("ANGLE", "radians", "grid rotation angle at U", "ANGLE"),
        gf("ANGLET", "radians", "grid rotation angle at T", "ANGLET"),
        gf("HTN", "m", "northern T-cell edge length", "HTN"),
        gf("HTE", "m", "eastern T-cell edge length", "HTE"),
        gf("dxt", "m", "T-cell width", "dxT"),
        gf("dyt", "m", "T-cell height", "dyT"),
        gf("dxu", "m", "U-cell width", "dxU"),
        gf("dyu", "m", "U-cell height", "dyU"),
        gf("tarea", "m^2", "T-cell area", "tarea"),
        gf("uarea", "m^2", "U-cell area", "uarea"),
        gf("tmask", "1", "ocean mask at T points", "hm"),
        gf("umask", "1", "ocean mask at U points", "uvm"),
    ]


def _vorticity(s, g):
    dvdx = (s.vvel - shift(s.vvel, 0, 1, bc=g.bc)) / _mx(g.dxU, cst.puny)
    dudy = (s.uvel - shift(s.uvel, 1, 0, bc=g.bc)) / _mx(g.dyU, cst.puny)
    return dvdx - dudy


def vector_diag_fields() -> List[HistoryField]:
    """Speed/direction diagnostics (f_atmspd/f_atmdir/f_ocnspd/f_ocndir/
    f_icespd/f_icedir; direction in degrees, meteorological convention)."""
    return [
        _ff("atmspd", "m/s", "wind speed",
            lambda s, fl, g, fc: torch.hypot(fc.uatm, fc.vatm)),
        _ff("atmdir", "deg", "wind direction (from)",
            lambda s, fl, g, fc: _deg_mod(-fc.uatm, -fc.vatm)),
        _ff("ocnspd", "m/s", "ocean current speed",
            lambda s, fl, g, fc: torch.hypot(fc.uocn, fc.vocn)),
        _ff("ocndir", "deg", "ocean current direction (to)",
            lambda s, fl, g, fc: _deg_mod(fc.uocn, fc.vocn)),
        _f("icespd", "m/s", "ice drift speed",
           lambda s, fl, g: torch.hypot(s.uvel, s.vvel)),
        _f("icedir", "deg", "ice drift direction (to)",
           lambda s, fl, g: _deg_mod(s.uvel, s.vvel)),
        _f("vort", "1/s", "ice vorticity (dv/dx - du/dy)",
           lambda s, fl, g: _vorticity(s, g)),
        _f("Tref", "C", "2 m reference temperature",
           lambda s, fl, g: fl.Tref - 273.15),
        _f("Qref", "kg/kg", "2 m reference specific humidity",
           lambda s, fl, g: fl.Qref),
        _f("Uref", "m/s", "10 m reference wind speed",
           lambda s, fl, g: fl.Uref),
        _f("mlt_onset", "day", "day of year of first surface melt",
           lambda s, fl, g: s.mlt_onset),
        _f("frz_onset", "day", "day of year of first frazil formation",
           lambda s, fl, g: s.frz_onset),
        _f("uvelE", "m/s", "C-grid east-face ice velocity (x)",
           lambda s, fl, g: s.uvelE),
        _f("vvelN", "m/s", "C-grid north-face ice velocity (y)",
           lambda s, fl, g: s.vvelN),
    ]


def ai_flux_fields() -> List[HistoryField]:
    """Grid-cell-mean (*_ai) flux variants: the reference reports most
    coupler fluxes both per unit ice area and per grid-cell area
    (f_evap_ai/f_fresh_ai/... ice_history.F90)."""
    def ai(name, units, long_name, attr):
        return _f(name + "_ai", units, long_name + " (cell mean)",
                  lambda s, fl, g: getattr(fl, attr) * s.aice)

    return [
        ai("evap", "kg/m^2/s", "evaporation", "evap"),
        ai("fresh", "kg/m^2/s", "freshwater flux to ocean", "fresh"),
        ai("fsalt", "kg/m^2/s", "salt flux to ocean", "fsalt"),
        ai("fhocn", "W/m^2", "heat flux to ocean", "fhocn"),
        ai("fswthru", "W/m^2", "SW through ice to ocean", "fswthru"),
        ai("fswabs", "W/m^2", "SW absorbed", "fswabs"),
        ai("flat", "W/m^2", "latent heat flux", "flat"),
        ai("fsens", "W/m^2", "sensible heat flux", "fsens"),
        ai("flwup", "W/m^2", "upward longwave", "flwout"),
        ai("alvdr", "1", "visible direct albedo", "alvdr"),
        ai("alvdf", "1", "visible diffuse albedo", "alvdf"),
        ai("alidr", "1", "near-IR direct albedo", "alidr"),
        ai("alidf", "1", "near-IR diffuse albedo", "alidf"),
    ]


def profile_fields(cfg) -> List[HistoryField]:
    """Vertical interior profiles on true 4Di/4Ds axes (f_Tinz/f_Sinz/
    f_Tsnz, reference ice_history_shared.F90:101-123): per-category,
    per-layer ice temperature/salinity and snow temperature inverted
    from the enthalpy/salinity tracers, one variable each with
    (nc, nkice)/(nc, nksnow) dims. BL99 only: `build_fields` refuses the
    mushy thermodynamics."""
    from ..columns.thermo_vertical import (bl99_salinity, melting_temps,
                                           temp_from_enthalpy_ice,
                                           temp_from_enthalpy_snow)
    nilyr = cfg.domain.nilyr
    nslyr = cfg.domain.nslyr
    di = (("nc", cfg.domain.ncat), ("nkice", nilyr))
    ds = (("nc", cfg.domain.ncat), ("nksnow", nslyr))
    salin = bl99_salinity(nilyr)

    def _alive(s, v):
        return torch.where(s.aicen[:, None] > cst.puny, v, 0.0)

    def tin(s, fl, g):
        q = s.trcrn["qice"]                       # (ncat, nilyr, ny, nx)
        Tm = torch.as_tensor(melting_temps(salin), dtype=q.dtype,
                             device=q.device)
        return _alive(s, temp_from_enthalpy_ice(q, Tm[None, :, None, None]))

    def sin_(s, fl, g):
        if "sice" in s.trcrn:
            return _alive(s, s.trcrn["sice"])
        prof = torch.as_tensor(salin, dtype=s.aicen.dtype,
                               device=s.aicen.device)
        return _alive(s, prof[None, :, None, None].expand(
            s.aicen.shape[:1] + (nilyr,) + s.aicen.shape[1:]))

    def tsn(s, fl, g):
        return _alive(s, temp_from_enthalpy_snow(s.trcrn["qsno"]))

    return [
        _f("Tinz", "C", "ice internal temperatures on CICE grid",
           tin, dims=di),
        _f("Sinz", "ppt", "ice internal bulk salinity", sin_, dims=di),
        _f("Tsnz", "C", "snow internal temperatures", tsn, dims=ds),
    ]


def category_fields(ncat: int) -> List[HistoryField]:
    """Per-category fields on the true 3Dc axis (reference
    ice_history_shared.F90:101-123 "3Dc"; one variable with an `nc`
    dimension, not per-category 2-D planes)."""
    c = (("nc", ncat),)
    return [
        _f("aicen", "1", "ice area, categories",
           lambda s, fl, g: s.aicen, dims=c),
        _f("vicen", "m", "ice volume, categories",
           lambda s, fl, g: s.vicen, dims=c),
        _f("vsnon", "m", "snow volume, categories",
           lambda s, fl, g: s.vsnon, dims=c),
        _f("Tsfcn", "C", "surface temperature, categories",
           lambda s, fl, g: s.trcrn["Tsfcn"], dims=c),
    ]


def cmip_si_fields(cfg) -> List[HistoryField]:
    """The full CMIP/SIMIP si* diagnostic set (reference f_si* registrations,
    ice_history.F90 icefields_nml). Implemented from the prognostic state +
    FluxOut sources; per-step melt/growth accumulators convert to mass-flux
    rates with the model dt. Temperatures follow the CMIP kelvin
    convention. sisndmasssubl has no source (no snow/ice sublimation
    split). BL99 only: `build_fields` refuses the mushy thermodynamics and
    the form drag (sidragtop/sidragbot)."""
    from ..columns.thermo_vertical import (bl99_salinity, melting_temps,
                                           temp_from_enthalpy_ice)
    dt = float(cfg.setup.dt)
    rhoi, rhos = cst.rhoi, cst.rhos
    grid_ice = cfg.grid.grid_ice
    Tm = melting_temps(bl99_salinity(cfg.domain.nilyr))

    def _m(x, a):  # per-ice-area mean from a cell mean
        return x / _mx(a, cst.puny)

    def _fb(s, fl, g):
        hi = _m(s.vice, s.aice)
        hs = _m(s.vsno, s.aice)
        return torch.clamp(hi - (rhoi * hi + rhos * hs) / cst.rhow, min=0.0)

    def _hc(s, fl, g):      # ice heat content (J/m^2, negative)
        return (s.trcrn["qice"].mean(1) * s.vicen).sum(0)

    def _snhc(s, fl, g):
        return (s.trcrn["qsno"].mean(1) * s.vsnon).sum(0)

    def _layer_temp(k):
        # temperature of ice layer k, category mean, in kelvin
        def fn(s, fl, g):
            T = temp_from_enthalpy_ice(s.trcrn["qice"][:, k], float(Tm[k]))
            return _agg(T, s.aicen, s.aice) + cst.Tffresh
        return fn

    def _masstran(s, fl, g, which):
        # x/y sea-ice mass transport through the E/N cell face (kg/s):
        # rhoi * vice averaged to the face * face-normal velocity * face
        # length (reference sidmasstranx accum, ice_history.F90)
        if which == "x":
            mE = grid_average_X2Y("S", rhoi * s.vice, "T", "E", g)
            u = (s.uvelE if grid_ice in ("C", "CD")
                 else grid_average_X2Y("S", s.uvel, "U", "E", g))
            return mE * u * g.dyE
        mN = grid_average_X2Y("S", rhoi * s.vice, "T", "N", g)
        v = (s.vvelN if grid_ice in ("C", "CD")
             else grid_average_X2Y("S", s.vvel, "U", "N", g))
        return mN * v * g.dxN

    def _shearmax(s, fl, g):
        sm = s.stressm.mean(0)
        s12 = s.stress12.mean(0)
        return torch.sqrt((0.5 * sm) ** 2 + s12 ** 2)

    def _sal(s):
        return (s.trcrn["sice"].mean(1) * s.vicen).sum(0)

    rate = 1.0 / dt
    F = [
        _f("sivol", "m", "sea-ice volume per area", lambda s, fl, g: s.vice),
        _f("sisnconc", "1", "snow area fraction",
           lambda s, fl, g: (s.aicen * (s.vsnon > cst.puny)).sum(0)),
        _f("sidir", "deg", "ice drift direction (to)",
           lambda s, fl, g: _deg_mod(s.uvel, s.vvel)),
        _f("sidivvel", "1/s", "ice velocity divergence",
           lambda s, fl, g: fl.divu),
        _f("sishearvel", "1/s", "ice shear deformation",
           lambda s, fl, g: fl.shear),
        _f("sidconcth", "1/s", "area tendency, thermo",
           lambda s, fl, g: fl.daidtt),
        _f("sidconcdyn", "1/s", "area tendency, dynamics",
           lambda s, fl, g: fl.daidtd),
        _f("sidmassth", "kg/m^2/s", "ice mass tendency, thermo",
           lambda s, fl, g: rhoi * fl.dvidtt),
        _f("sidmassdyn", "kg/m^2/s", "ice mass tendency, dynamics",
           lambda s, fl, g: rhoi * fl.dvidtd),
        _f("sidmassgrowthwat", "kg/m^2/s", "frazil ice growth",
           lambda s, fl, g: rhoi * fl.frazil * rate),
        _f("sidmassgrowthbot", "kg/m^2/s", "congelation ice growth",
           lambda s, fl, g: rhoi * fl.congel * rate),
        _f("sidmassgrowthsi", "kg/m^2/s", "snow-ice formation",
           lambda s, fl, g: rhoi * fl.snoice * rate),
        _f("sidmassmelttop", "kg/m^2/s", "top ice melt",
           lambda s, fl, g: rhoi * fl.meltt * rate),
        _f("sidmassmeltbot", "kg/m^2/s", "bottom ice melt",
           lambda s, fl, g: rhoi * fl.meltb * rate),
        _f("sidmassmeltlat", "kg/m^2/s", "lateral ice melt",
           lambda s, fl, g: rhoi * fl.meltl * rate),
        _f("sidmassevapsubl", "kg/m^2/s", "evaporation/sublimation mass flux",
           lambda s, fl, g: fl.evap),
        _f("sidmasstranx", "kg/s", "x ice mass transport (E face)",
           lambda s, fl, g: _masstran(s, fl, g, "x")),
        _f("sidmasstrany", "kg/s", "y ice mass transport (N face)",
           lambda s, fl, g: _masstran(s, fl, g, "y")),
        _f("sifb", "m", "ice freeboard above sea level", _fb),
        _f("sihc", "J/m^2", "ice heat content", _hc),
        _f("sisnhc", "J/m^2", "snow heat content", _snhc),
        _f("sicompstren", "N/m", "compressive ice strength",
           lambda s, fl, g: fl.strength),
        _f("sisali", "psu", "bulk sea-ice salinity",
           lambda s, fl, g: _sal(s) / _mx(s.vice, cst.puny)
           if "sice" in s.trcrn else torch.zeros_like(s.aice)),
        _f("sisaltmass", "kg/m^2", "mass of salt in sea ice",
           lambda s, fl, g: rhoi * _sal(s) * 1e-3
           if "sice" in s.trcrn else torch.zeros_like(s.aice)),
        _f("sitempbot", "K", "ice bottom temperature",
           _layer_temp(cfg.domain.nilyr - 1)),
        # snow-ice interface temperature ~ top ice layer temperature
        # (delta: the reference diagnoses the conductive interface value)
        _f("sitempsnic", "K", "snow-ice interface temperature",
           _layer_temp(0)),
        _f("sistressave", "N/m", "average normal stress",
           lambda s, fl, g: 0.125 * s.stressp.sum(0)),
        _f("sistressmax", "N/m", "maximum shear stress", _shearmax),
        _f("sistrxdtop", "N/m^2", "x atm stress on ice",
           lambda s, fl, g: fl.strairx),
        _f("sistrydtop", "N/m^2", "y atm stress on ice",
           lambda s, fl, g: fl.strairy),
        _f("sistrxubot", "N/m^2", "x ocean stress on ice",
           lambda s, fl, g: fl.strocnx),
        _f("sistryubot", "N/m^2", "y ocean stress on ice",
           lambda s, fl, g: fl.strocny),
        _f("siforceintstrx", "N/m^2", "internal stress divergence x",
           lambda s, fl, g: fl.strintx),
        _f("siforceintstry", "N/m^2", "internal stress divergence y",
           lambda s, fl, g: fl.strinty),
        _f("siforcecoriolx", "N/m^2", "Coriolis force term x",
           lambda s, fl, g: _mass(s) * _fcor(g) * s.vvel),
        _f("siforcecorioly", "N/m^2", "Coriolis force term y",
           lambda s, fl, g: -_mass(s) * _fcor(g) * s.uvel),
        # surface/bottom energy fluxes over ice
        _f("siflsenstop", "W/m^2", "sensible heat flux over ice",
           lambda s, fl, g: fl.fsens),
        _f("sifllattop", "W/m^2", "latent heat flux over ice",
           lambda s, fl, g: fl.flat),
        _f("sifllwutop", "W/m^2", "upward longwave over ice",
           lambda s, fl, g: fl.flwout),
        _f("siflcondtop", "W/m^2", "conductive flux at ice top",
           lambda s, fl, g: fl.fcondtop),
        _f("siflswdbot", "W/m^2", "shortwave through ice to ocean",
           lambda s, fl, g: fl.fswthru),
        _f("siflfwbot", "kg/m^2/s", "freshwater flux to ocean",
           lambda s, fl, g: fl.fresh),
        _f("siflsaltbot", "kg/m^2/s", "salt flux to ocean",
           lambda s, fl, g: fl.fsalt),
        # forcing-sourced fluxes over the ice fraction
        _ff("sifllwdtop", "W/m^2", "downward longwave over ice",
            lambda s, fl, g, fc: fc.flw * s.aice),
        _ff("siflswdtop", "W/m^2", "downward shortwave over ice",
            lambda s, fl, g, fc: (fc.swvdr + fc.swvdf + fc.swidr +
                                  fc.swidf) * s.aice),
        _ff("siflswutop", "W/m^2", "upward shortwave over ice",
            lambda s, fl, g, fc: (fc.swvdr * fl.alvdr + fc.swvdf * fl.alvdf +
                                  fc.swidr * fl.alidr + fc.swidf * fl.alidf)),
        _ff("sipr", "kg/m^2/s", "rainfall over ice",
            lambda s, fl, g, fc: fc.frain * s.aice),
        _ff("siforcetiltx", "N/m^2", "sea-surface tilt force x",
            lambda s, fl, g, fc: -_mass(s) * cst.gravit * fc.ss_tltx),
        _ff("siforcetilty", "N/m^2", "sea-surface tilt force y",
            lambda s, fl, g, fc: -_mass(s) * cst.gravit * fc.ss_tlty),
        _ff("sisndmasssnf", "kg/m^2/s", "snowfall onto ice",
            lambda s, fl, g, fc: fc.fsnow * s.aice),
        _f("sisndmassmelt", "kg/m^2/s", "snow mass loss, melt",
           lambda s, fl, g: -rhos * fl.melts * rate),
        _f("sisndmasssi", "kg/m^2/s", "snow mass loss, snow-ice conversion",
           lambda s, fl, g: -rhoi * fl.snoice * rate),
    ]
    # per-category SIMIP fields on the true 3Dc axis
    c = (("nc", cfg.domain.ncat),)
    F += [
        _f("siitdconc", "1", "ice area fractions in thickness categories",
           lambda s, fl, g: s.aicen, dims=c),
        _f("siitdthick", "m", "ice thickness in categories",
           lambda s, fl, g: s.vicen / _mx(s.aicen, cst.puny), dims=c),
        _f("siitdsnconc", "1", "snow cover in categories",
           lambda s, fl, g: s.aicen * (s.vsnon > cst.puny), dims=c),
        _f("siitdsnthick", "m", "snow depth in categories",
           lambda s, fl, g: s.vsnon / _mx(s.aicen, cst.puny), dims=c),
    ]
    return F


def tensor_fields(cfg) -> List[HistoryField]:
    """Stress & strain tensor components (reference f_e11/f_e12/f_e22,
    f_s11/f_s12/f_s22; EAP adds f_a11/f_a12). Stress components come from
    the corner-mean prognostic tensor (sp = s11+s22, sm = s11-s22); strain
    rates from centered B-grid velocity differences at T points."""
    def _edges(s, g):
        # U(i,j) = NE corner of T(i,j); T-cell edge means of u, v
        bc = g.bc
        u, v = s.uvel, s.vvel
        uS = shift(u, -1, 0, bc=bc)      # U(i,j-1): SE corner
        uW = shift(u, 0, -1, bc=bc)      # NW corner
        uSW = shift(u, -1, -1, bc=bc)
        vS = shift(v, -1, 0, bc=bc)
        vW = shift(v, 0, -1, bc=bc)
        vSW = shift(v, -1, -1, bc=bc)
        return u, uS, uW, uSW, v, vS, vW, vSW

    def e11(s, fl, g):
        u, uS, uW, uSW, *_ = _edges(s, g)
        return (0.5 * (u + uS) - 0.5 * (uW + uSW)) / g.dxT

    def e22(s, fl, g):
        u, uS, uW, uSW, v, vS, vW, vSW = _edges(s, g)
        return (0.5 * (v + vW) - 0.5 * (vS + vSW)) / g.dyT

    def e12(s, fl, g):
        u, uS, uW, uSW, v, vS, vW, vSW = _edges(s, g)
        dudy = (0.5 * (u + uW) - 0.5 * (uS + uSW)) / g.dyT
        dvdx = (0.5 * (v + vS) - 0.5 * (vW + vSW)) / g.dxT
        return 0.5 * (dudy + dvdx)

    F = [
        _f("e11", "1/s", "strain rate e11 at T", e11),
        _f("e22", "1/s", "strain rate e22 at T", e22),
        _f("e12", "1/s", "strain rate e12 at T", e12),
        _f("s11", "N/m", "stress tensor s11",
           lambda s, fl, g: 0.5 * (s.stressp.mean(0) + s.stressm.mean(0))),
        _f("s22", "N/m", "stress tensor s22",
           lambda s, fl, g: 0.5 * (s.stressp.mean(0) - s.stressm.mean(0))),
        _f("s12", "N/m", "stress tensor s12",
           lambda s, fl, g: s.stress12.mean(0)),
    ]
    if cfg.dynamics.kdyn == 2:
        F += [
            _f("a11", "1", "EAP structure tensor a11",
               lambda s, fl, g: s.a11.mean(0)),
            _f("a12", "1", "EAP structure tensor a12",
               lambda s, fl, g: s.a12.mean(0)),
        ]
    return F


def grid_extra_fields() -> List[HistoryField]:
    """N/E-grid static planes (reference f_dxn/f_dxe/f_dyn/f_dye/f_narea/
    f_earea/f_nmask/f_emask + derived NLAT/NLON/ELAT/ELON coordinates)."""
    deg = cst.rad_to_deg

    def gf(name, units, long_name, attr, scale=1.0):
        return HistoryField(name, units, long_name,
                            lambda s, fl, g: getattr(g, attr) * scale,
                            cell_mask=False)

    def _avg(attr, dy, dx, scale):
        def fn(s, fl, g):
            a = getattr(g, attr)
            return 0.5 * (a + shift(a, dy, dx, bc=g.bc)) * scale
        return fn

    return [
        gf("dxn", "m", "N-face cell width", "dxN"),
        gf("dyn", "m", "N-face cell height", "dyN"),
        gf("dxe", "m", "E-face cell width", "dxE"),
        gf("dye", "m", "E-face cell height", "dyE"),
        gf("narea", "m^2", "N-face area", "narea"),
        gf("earea", "m^2", "E-face area", "earea"),
        gf("nmask", "1", "ocean mask at N points", "npm"),
        gf("emask", "1", "ocean mask at E points", "epm"),
        HistoryField("NLAT", "degrees_north", "N-face latitude",
                     _avg("TLAT", 1, 0, deg), cell_mask=False),
        HistoryField("NLON", "degrees_east", "N-face longitude",
                     _avg("TLON", 1, 0, deg), cell_mask=False),
        HistoryField("ELAT", "degrees_north", "E-face latitude",
                     _avg("TLAT", 0, 1, deg), cell_mask=False),
        HistoryField("ELON", "degrees_east", "E-face longitude",
                     _avg("TLON", 0, 1, deg), cell_mask=False),
    ]


def precip_extra_fields() -> List[HistoryField]:
    """rain/snow cell-mean deposition (reference f_rain_ai/f_snow_ai) and
    upward shortwave over ice (f_fswup)."""
    return [
        _ff("rain_ai", "kg/m^2/s", "rainfall over ice (cell mean)",
            lambda s, fl, g, fc: fc.frain * s.aice),
        _ff("snow_ai", "kg/m^2/s", "snowfall over ice (cell mean)",
            lambda s, fl, g, fc: fc.fsnow * s.aice),
        _ff("fswup", "W/m^2", "upward shortwave over ice",
            lambda s, fl, g, fc: (fc.swvdr * fl.alvdr + fc.swvdf * fl.alvdf +
                                  fc.swidr * fl.alidr + fc.swidf * fl.alidf)),
    ]


def pond_extra_fields(cfg) -> List[HistoryField]:
    """Per-category pond fields (reference f_apondn/f_hpondn/f_ipondn),
    on the 3Dc axis."""
    ncat = cfg.domain.ncat
    c = (("nc", ncat),)
    F = [
        _f("apondn", "1", "melt pond fraction, categories",
           lambda s, fl, g: s.trcrn["apnd"] * s.aicen, dims=c),
        _f("hpondn", "m", "melt pond depth, categories",
           lambda s, fl, g: s.trcrn["hpnd"], dims=c),
        _f("ipondn", "m", "melt pond lid thickness, categories",
           lambda s, fl, g: s.trcrn["ipnd"], dims=c),
        _f("simpconc", "1", "meltpond area fraction of ice (SIMIP)",
           lambda s, fl, g: _agg(s.trcrn["apnd"], s.aicen, s.aice)),
        _f("simpthick", "m", "meltpond depth (SIMIP)",
           lambda s, fl, g: _agg(s.trcrn["hpnd"], s.aicen, s.aice)),
        _f("simprefrozen", "m", "refrozen pond lid thickness (SIMIP)",
           lambda s, fl, g: _agg(s.trcrn["ipnd"], s.aicen, s.aice)),
        # pond water budget terms (reference f_dpnd_* in ice_history_pond;
        # cell-mean m of water per step; dpnd_flush = f_fpond source)
        _f("dpnd_initial", "m/step", "pond water collected",
           lambda s, fl, g: fl.dpnd_initial),
        _f("dpnd_expon", "m/step", "pond drainage, exponential above-SL",
           lambda s, fl, g: fl.dpnd_expon),
        _f("dpnd_freebd", "m/step", "pond drainage, freeboard overflow",
           lambda s, fl, g: fl.dpnd_freebd),
        _f("dpnd_dlid", "m/step", "pond water frozen into the lid",
           lambda s, fl, g: fl.dpnd_dlid),
    ]
    for key in ("dpnd_flushn", "dpnd_initialn", "dpnd_exponn",
                "dpnd_freebdn", "dpnd_dlidn"):
        F.append(_f(key, "m/step", f"{key[:-1]} (cell mean), categories",
                    _cat3(key, ncat), dims=c))
    F += [
        # pond water lost with melting / ridging ice (reference dpnd_melt/
        # dpnd_ridge, ice_history_pond.F90:572-574)
        _f("dpnd_melt", "m/step", "pond water lost with melted ice",
           _nf2d("dpnd_melt")),
        _f("dpnd_ridge", "m/step", "pond water lost in ridging",
           _nf2d("dpnd_ridge")),
        # radiatively-effective pond fraction (reference apeffn 3Dc +
        # apeff_ai 2D, ice_history_pond.F90:294,410; fl.apeff is the cell
        # mean, the 3Dc plane is the raw per-category fraction)
        _f("apeffn", "1", "effective pond fraction, categories",
           _cat3("apeffn", ncat), dims=c),
        _f("apeff_ai", "1", "effective pond fraction (cell mean)",
           lambda s, fl, g: fl.apeff),
    ]
    return F


def mechred_extra_fields(cfg) -> List[HistoryField]:
    """Per-category ridged planes + SIMIP ridge aliases (reference
    f_ardgn/f_vrdgn, f_sirdgconc/f_sirdgthick)."""
    ncat = cfg.domain.ncat
    c = (("nc", ncat),)

    def _ardgn(s):
        return (1.0 - torch.clamp(s.trcrn["alvl"], 0, 1)) * s.aicen

    def _vrdgn(s):
        return (1.0 - torch.clamp(s.trcrn["vlvl"], 0, 1)) * s.vicen

    F = [
        _f("ardgn", "1", "ridged ice area fraction, categories",
           lambda s, fl, g: _ardgn(s), dims=c),
        _f("vrdgn", "m", "ridged ice volume, categories",
           lambda s, fl, g: _vrdgn(s), dims=c),
        _f("sirdgconc", "1", "ridged ice area fraction (SIMIP)",
           lambda s, fl, g: _ardgn(s).sum(0)),
        _f("sirdgthick", "m", "ridged ice thickness (SIMIP)",
           lambda s, fl, g: _vrdgn(s).sum(0) /
           _mx(_ardgn(s).sum(0), cst.puny)),
    ]
    # per-category ridging process diagnostics (reference f_dardg1ndt/
    # f_dardg2ndt/f_dvirdgndt/f_aparticn/f_krdgn/f_aredistn/f_vredistn in
    # ice_history_mechred.F90), sourced from the ridge_ice diagnostics
    for key, units, long in (
            ("dardg1ndt", "1/s", "donor area ridging rate"),
            ("dardg2ndt", "1/s", "new ridge area rate"),
            ("dvirdgndt", "m/s", "ridged volume rate"),
            ("aparticn", "1", "ridging participation function"),
            ("krdgn", "1", "ridge thickness multiplier"),
            ("aredistn", "1", "new ridge area redistribution"),
            ("vredistn", "m", "new ridge volume redistribution"),
            # rafting split of the redistribution (thin donors double up;
            # reference araftn/vraftn, ice_history_mechred.F90:338-344)
            ("araftn", "1", "rafted ice area"),
            ("vraftn", "m", "rafted ice volume")):
        F.append(_f(key, units, f"{long}, categories", _cat3(key, ncat),
                    dims=c))
    return F


def flux_diag_fields(cfg) -> List[HistoryField]:
    """Extended flux diagnostics riding the FluxOut additions (reference
    f_fbot/f_fswint_ai/f_albsno/f_albpnd/f_albice/f_apeff/f_meltsliq/
    f_snowfrac/f_fpond + SIMIP siflsensbot/siflcondbot/siflfwdrain/
    sisndmassdyn and the per-category 3Dc *_ai planes)."""
    ncat = cfg.domain.ncat
    F = [
        _f("fbot", "W/m^2", "ocean heat used at the ice bottom",
           lambda s, fl, g: fl.fbot),
        _f("fswint_ai", "W/m^2", "SW absorbed in ice interior (cell mean)",
           lambda s, fl, g: fl.fswint),
        _f("fpond", "kg/m^2/s", "pond drainage freshwater flux",
           lambda s, fl, g: fl.fpond),
        _f("apeff", "1", "radiatively-effective pond fraction (cell mean)",
           lambda s, fl, g: fl.apeff),
        _f("meltsliq", "kg/m^2", "snow liquid runoff per step",
           lambda s, fl, g: fl.meltsliq),
        _f("snowfrac", "1", "snow-covered fraction",
           lambda s, fl, g: fl.snowfrac),
        _f("albice", "1", "broadband albedo, bare ice surface",
           lambda s, fl, g: fl.albice),
        _f("albsno", "1", "broadband albedo, snow surface",
           lambda s, fl, g: fl.albsno),
        _f("albpnd", "1", "broadband albedo, ponded surface",
           lambda s, fl, g: fl.albpnd),
        _f("siflsensbot", "W/m^2", "sensible heat at ice bottom (SIMIP)",
           lambda s, fl, g: fl.fbot),
        _f("siflcondbot", "W/m^2", "conductive flux at ice bottom (SIMIP)",
           lambda s, fl, g: fl.fcondbot),
        _f("siflfwdrain", "kg/m^2/s", "pond drainage to ocean (SIMIP)",
           lambda s, fl, g: fl.fpond),
        _f("simpeffconc", "1", "effective pond fraction of ice (SIMIP)",
           lambda s, fl, g: fl.apeff / _mx(s.aice, cst.puny)),
        _f("sisndmassdyn", "kg/m^2/s", "snow mass tendency, dynamics (SIMIP)",
           lambda s, fl, g: cst.rhos * fl.dvsdtd),
        # snow sublimation mass flux (reference evaps -> sisndmasssubl
        # CMIP field, ice_history.F90:1807,2999)
        _f("sisndmasssubl", "kg m-2 s-1",
           "snow mass change by sublimation/frost (CMIP)", _nf2d("evaps")),
        # net surface heat flux causing melt (reference fmeltt_ai,
        # ice_history.F90:1384)
        _f("fmeltt_ai", "W/m^2", "net surface heat flux causing melt",
           lambda s, fl, g: fl.ncat_fluxes["fmelttn"].sum(0)
           if "fmelttn" in fl.ncat_fluxes else torch.zeros_like(s.aice)),
        # shortwave scaling factor (reference scale_factor <- fswfac,
        # ice_history.F90:861; ==1 when radiation runs in-step)
        _f("scale_factor", "1", "shortwave scaling factor",
           _nf2d("scale_factor")),
    ]
    c = (("nc", ncat),)
    for key, units, long in (("fsurfn", "W/m^2", "net surface flux"),
                             ("fcondtopn", "W/m^2", "top conductive flux"),
                             ("flatn", "W/m^2", "latent heat flux"),
                             ("fsensn", "W/m^2", "sensible heat flux"),
                             ("melttn", "m/step", "top ice melt"),
                             ("fmelttn", "W/m^2",
                              "net surface heat flux causing melt")):
        F.append(_f(f"{key}_ai", units, f"{long} (cell mean), categories",
                    _cat3(key, ncat), dims=c))
    # surface-to-top-layer conductance per category (reference keffn_top
    # 3Dc, ice_history.F90:1922; raw plane, not area-weighted)
    F.append(_f("keffn_top", "W/m^2/K",
                "effective thermal conductivity of the top ice/snow layer,"
                " categories", _cat3("keffn_top", ncat), dims=c))
    return F


def parity_extra_fields(cfg) -> List[HistoryField]:
    """Upward longwave, ice-presence indicators, level-ice and pond cell
    means, tilt/Coriolis stresses, and on C/CD grids the face-velocity
    speed/direction diagnostics (reference ice_history.F90:63-2193)."""
    t = cfg.tracers
    F = [
        _f("flwup", "W/m^2", "upward longwave flux (cpl)",
           lambda s, fl, g: fl.flwout),
        _f("ice_present", "1",
           "fraction of time-avg interval that ice is present",
           lambda s, fl, g: _flag(s.aice > cst.puny, s.aice)),
    ]
    if t.tr_lvl:
        F += [
            _f("alvl", "1", "level ice area fraction (cell mean)",
               lambda s, fl, g: (torch.clamp(s.trcrn["alvl"], 0, 1)
                                 * s.aicen).sum(0)),
            _f("vlvl", "m", "level ice volume (cell mean)",
               lambda s, fl, g: (torch.clamp(s.trcrn["vlvl"], 0, 1)
                                 * s.vicen).sum(0)),
        ]
    if t.tr_pond_lvl or t.tr_pond_topo or t.tr_pond_sealvl:
        F += [
            _f("apond_ai", "1", "melt pond fraction of grid cell",
               lambda s, fl, g: (s.trcrn["apnd"] * s.aicen).sum(0)),
            _f("hpond_ai", "m", "mean melt pond depth over grid cell",
               lambda s, fl, g: (s.trcrn["apnd"] * s.trcrn["hpnd"]
                                 * s.aicen).sum(0)),
            _f("ipond_ai", "m", "mean pond lid thickness over grid cell",
               lambda s, fl, g: (s.trcrn["apnd"] * s.trcrn["ipnd"]
                                 * s.aicen).sum(0)),
        ]
    if t.tr_iage:
        F.append(_f("siage", "s", "sea ice age (SIMIP)",
                    lambda s, fl, g: _agg(s.trcrn["iage"], s.aicen,
                                          s.aice)))
    if t.tr_pond_lvl or t.tr_pond_sealvl:
        F.append(_f("dpnd_flush", "m/step",
                    "pond water drained by flushing (cell mean)",
                    lambda s, fl, g: fl.ncat_fluxes["dpnd_flushn"].sum(0)
                    if "dpnd_flushn" in fl.ncat_fluxes
                    else torch.zeros_like(s.aice)))
    F += [
        _ff("strtltx", "N/m^2", "sea surface tilt stress x",
            lambda s, fl, g, fc: -_mass(s) * cst.gravit * fc.ss_tltx),
        _ff("strtlty", "N/m^2", "sea surface tilt stress y",
            lambda s, fl, g, fc: -_mass(s) * cst.gravit * fc.ss_tlty),
        _f("strcorx", "N/m^2", "Coriolis stress x",
           lambda s, fl, g: _mass(s) * _fcor(g) * s.vvel),
        _f("strcory", "N/m^2", "Coriolis stress y",
           lambda s, fl, g: -_mass(s) * _fcor(g) * s.uvel),
        # EAP structure tensor (corner-mean; isotropic = 0.5/0 when
        # kdyn != 2; reference ice_history f_a11/f_a12 from ice_dyn_eap)
        _f("a11", "1", "structure tensor component a11",
           lambda s, fl, g: s.a11.mean(0)),
        _f("a12", "1", "structure tensor component a12",
           lambda s, fl, g: s.a12.mean(0)),
        _f("aice_init", "1", "ice area at start of the step",
           _nf2d("aice_init")),
    ]
    if cfg.grid.grid_ice in ("C", "CD"):
        def spd(u, v):
            return lambda s, fl, g: torch.sqrt(getattr(s, u) ** 2 +
                                               getattr(s, v) ** 2)

        def drn(u, v):
            def fn(s, fl, g):
                d = 90.0 - torch.atan2(getattr(s, v), getattr(s, u)) \
                    * cst.rad_to_deg
                return torch.where(d < 0.0, d + 360.0, d)
            return fn
        for key, long in (("strintxE", "internal stress x at E point"),
                          ("strintyN", "internal stress y at N point"),
                          ("strintyE", "internal stress y at E point"),
                          ("strintxN", "internal stress x at N point"),
                          ("taubxE", "seabed stress x at E point"),
                          ("taubyN", "seabed stress y at N point"),
                          ("taubyE", "seabed stress y at E point"),
                          ("taubxN", "seabed stress x at N point"),
                          ("strocnxE", "ocean stress x at E point"),
                          ("strocnyE", "ocean stress y at E point"),
                          ("strocnxN", "ocean stress x at N point"),
                          ("strocnyN", "ocean stress y at N point"),
                          # momentum-balance splits at the faces
                          # (reference strair*/strcor*/strtlt* E/N,
                          # ice_history.F90 CD section)
                          ("strairxE", "air stress x at E point"),
                          ("strairyE", "air stress y at E point"),
                          ("strairxN", "air stress x at N point"),
                          ("strairyN", "air stress y at N point"),
                          ("strcorxE", "Coriolis stress x at E point"),
                          ("strcoryE", "Coriolis stress y at E point"),
                          ("strcorxN", "Coriolis stress x at N point"),
                          ("strcoryN", "Coriolis stress y at N point"),
                          ("strtltxE", "sea sfc tilt stress x at E point"),
                          ("strtltyE", "sea sfc tilt stress y at E point"),
                          ("strtltxN", "sea sfc tilt stress x at N point"),
                          ("strtltyN", "sea sfc tilt stress y at N point")):
            F.append(_f(key, "N/m^2", long, _nf2d(key)))
        F += [
            _f("uvelN", "m/s", "ice velocity u at N point",
               lambda s, fl, g: s.uvelN),
            _f("vvelE", "m/s", "ice velocity v at E point",
               lambda s, fl, g: s.vvelE),
            _f("icespdE", "m/s", "ice speed at E point",
               spd("uvelE", "vvelE")),
            _f("icespdN", "m/s", "ice speed at N point",
               spd("uvelN", "vvelN")),
            _f("icedirE", "deg", "ice direction at E point (from north)",
               drn("uvelE", "vvelE")),
            _f("icedirN", "deg", "ice direction at N point (from north)",
               drn("uvelN", "vvelN")),
        ]
    if cfg.dynamics.kdyn == 2:
        # EAP yield-surface stress tensor (reference yieldstress11/12/22,
        # ice_dyn_eap.F90:1436-1446 / ice_history registrations)
        for key, long in (("yieldstress11", "yield stress sigma_11"),
                          ("yieldstress12", "yield stress sigma_12"),
                          ("yieldstress22", "yield stress sigma_22")):
            F.append(_f(key, "N/m", long, _nf2d(key)))
    return F


def build_fields(cfg) -> List[HistoryField]:
    """Full conditional registry (init_hist honoring the tracer flags —
    reference icefields_*_nml groups), in the JAX package's order."""
    t, d = cfg.tracers, cfg.domain
    waiting = [name for name, on in (
        ("snow", t.tr_snow), ("fsd", t.tr_fsd),
        ("bgc", cfg.zbgc.skl_bgc), ("zbgc", cfg.zbgc.z_tracers),
        ("hbrine", t.tr_brine), ("drag", cfg.forcing.formdrag),
        ("aero_iso", (t.tr_aero and d.n_aero) or (t.tr_iso and d.n_iso)),
        ("mushy profile and CMIP temperatures", cfg.thermo.ktherm == 2))
        if on]
    if waiting:
        raise NotImplementedError(
            f"history groups {', '.join(waiting)} are not ported yet "
            "(ROADMAP A6: column options)")
    fields = default_fields() + dyn_fields() + forcing_fields() \
        + flux_extra_fields() + category_fields(cfg.domain.ncat) \
        + grid_fields() + grid_extra_fields() + vector_diag_fields() \
        + ai_flux_fields() + profile_fields(cfg) + tensor_fields(cfg) \
        + precip_extra_fields() + flux_diag_fields(cfg) \
        + parity_extra_fields(cfg)
    if t.tr_iage and t.tr_FY:
        fields += age_fields()
    if t.tr_pond_lvl or t.tr_pond_topo or t.tr_pond_sealvl:
        fields += pond_fields() + pond_extra_fields(cfg)
    if t.tr_lvl:
        fields += mechred_fields() + mechred_extra_fields(cfg)
    if cfg.setup.hist_cmip:
        fields += cmip_fields() + cmip_si_fields(cfg)
    # dedupe by name, first registration wins
    seen = set()
    out = []
    for f in fields:
        if f.name not in seen:
            seen.add(f.name)
            out.append(f)
    return out
