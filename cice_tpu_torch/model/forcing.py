"""Atmospheric and oceanic forcing (PyTorch port of
cice_tpu/model/forcing.py; reference ice_forcing.F90).

Analytic modes: the Hunke (2001) box2001 rotating winds and gyre currents
(box2001_data_atm :5112-5202, box2001_data_ocn :5206-5251), constant
`uniform_*` and `calm` winds (:319-343), and the file-less `seasonal`
annual cycle, which also stands in for the dataset atmospheres when no
`atm_data_dir` is set. File datasets (`ncar`, `jra55`, `monthly`,
`hadgem`, `oned`, `ISPOL` atmospheres; `clim`/`ncar`, `hycom` oceans) go
through `io.forcing_files` and `prepare_forcing` (:1603): SW band split,
longwave closure, humidity caps, precipitation units and the rotation of
geographic vectors into grid components through ANGLET.

The datasets belong to the caller (`Model.datasets`): the JAX package
keeps them in a module dictionary keyed by `id(cfg)`, which hands a later
Config that reuses a freed id the first one's dataset; the wave-spectrum
file dataset is kept the same way, under the stream 'wave'.

Wave spectra (reference get_wave_spec): the 25-bin WW3 frequency grid, a
Bretschneider spectrum of the local wind sea, or a wave model's monthly
spectra from `wave_spec_file`.
"""

from __future__ import annotations

import functools
import math

import torch

from .. import constants as cst
from ..ops import lsum
from ..columns.ocean import freezing_temperature
from ..core.halo import TileBC
from ..columns.orbit import OrbitalParams, compute_coszen, orb_params
from .flux import Forcing, zeros_forcing

UNIFORM = ("uniform_east", "uniform_north", "uniform_west", "uniform_south",
           "calm")
FILE_ATM = ("ncar", "jra55", "monthly", "hadgem", "oned", "ISPOL")


def orbital_from_cfg(cfg) -> OrbitalParams:
    """Orbital parameters from the config (reference orb_mode,
    ice_comp_nuopc.F90:87-96): 'fixed_year' evaluates `orb_params` for
    forcing.orb_iyear, 'fixed_parameters' takes the explicit values."""
    f = cfg.forcing
    mode = getattr(f, "orb_mode", "fixed_year")
    if mode == "fixed_parameters":
        return OrbitalParams(eccen=f.orb_eccen, obliq=f.orb_obliq,
                             mvelp=f.orb_mvelp)
    if mode != "fixed_year":
        raise ValueError(f"orb_mode={mode!r}: expected 'fixed_year' or "
                         "'fixed_parameters'")
    return orb_params(getattr(f, "orb_iyear", 2000))


def default_coszen(grid, yday: float, params: OrbitalParams = OrbitalParams(),
                   cfg=None):
    """Daily-mean cosine solar zenith and eccentricity factor on the T
    grid (reference compute_coszen ice_forcing.F90:2558)."""
    if cfg is not None:
        params = orbital_from_cfg(cfg)
    return compute_coszen(grid.TLAT, grid.TLON, yday, params,
                          daily_mean=True)


def shortwave_bands(fsw):
    """(vdr, vdf, idr, idf) of the net incoming SW."""
    return (fsw * 0.28, fsw * 0.24, fsw * 0.31, fsw * 0.17)


def qa_saturation(Tair_K, rhoa):
    """Saturation specific humidity over water at Tair."""
    return (cst.qqqocn / torch.clamp(rhoa, min=1e-8)) * \
        torch.exp(-cst.TTTocn / Tair_K)


def longwave_rosati_miyakoda(Tair_K, Tsfc_K, Qa, cldf):
    """Downward longwave (W/m^2), Rosati & Miyakoda (1988) (reference
    ice_forcing.F90:1847); Tsfc_K and Qa do not enter it."""
    fcc = 1.0 - 0.8 * cldf
    ptem = Tair_K
    return (cst.stefan_boltzmann * ptem ** 4
            * (1.0 - 0.261 * torch.exp(-7.77e-4 * (273.0 - ptem) ** 2))
            * fcc)


def _full(grid, v, dtype):
    return torch.full(grid.shape, v, dtype=dtype, device=grid.device)


# ---------------------------------------------------------------------------
# analytic wind and current fields
# ---------------------------------------------------------------------------

def _ij(grid, dtype):
    """The 1-based global column and row of each cell over the global
    extents (on a tile grid its own columns and rows)."""
    ny, nx = grid.global_shape
    ly, lx = grid.shape
    y0, x0 = ((grid.bc.y0, grid.bc.x0) if isinstance(grid.bc, TileBC)
              else (0, 0))
    dev = grid.device
    ii = (torch.arange(x0, x0 + lx, dtype=dtype, device=dev)
          + 1.0)[None, :] / nx
    jj = (torch.arange(y0, y0 + ly, dtype=dtype, device=dev)
          + 1.0)[:, None] / ny
    return ii, jj


def _tiles(grid, raw: dict) -> dict:
    """A dataset record's global (..., ny, nx) fields cut to the grid's
    tile (as they are on a whole grid)."""
    bc = grid.bc
    if not isinstance(bc, TileBC):
        return raw
    return {k: (bc.tile(v) if torch.is_tensor(v) and v.ndim >= 2 and
                tuple(v.shape[-2:]) == (bc.ny, bc.nx) else v)
            for k, v in raw.items()}


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


def uniform_atm(grid, direction: str, speed: float, aice,
                fc: Forcing) -> Forcing:
    """Constant winds (reference :319-343): `uniform_*` at `speed`, or
    `calm`."""
    dirs = dict(uniform_east=(speed, 0.0), uniform_north=(0.0, speed),
                uniform_west=(-speed, 0.0), uniform_south=(0.0, -speed),
                calm=(0.0, 0.0))
    ua, va = dirs[direction]
    uatm = _full(grid, ua, fc.uatm.dtype)
    vatm = _full(grid, va, fc.uatm.dtype)
    wind = torch.sqrt(uatm ** 2 + vatm ** 2)
    tau = fc.rhoa * 0.0012 * wind
    return fc.replace(uatm=uatm, vatm=vatm, wind=wind,
                      strax=aice * tau * uatm, stray=aice * tau * vatm)


def seasonal_atm(grid, yday: float, fc: Forcing, *, winter_Tair=-30.0,
                 summer_Tair=2.0, cldf=0.5) -> Forcing:
    """Annual-cycle air state varying with latitude and day of year: every
    field step_therm1 needs, with plausible polar magnitudes (the
    stand-in for dataset forcing when no files are configured)."""
    lat = grid.TLAT
    dt = fc.Tair.dtype
    coszen, eccf = default_coszen(grid, yday)
    fsw = 1365.0 * eccf * 0.7 * coszen * (1.0 - 0.6 * cldf)
    phase = math.cos(2.0 * math.pi * (yday - 202.0) / 365.0)
    seasonal = 0.5 * (1.0 - phase * torch.sign(lat))
    Tair_c = winter_Tair + (summer_Tair - winter_Tair) * seasonal
    # moderate toward the equator
    w = torch.clamp(lat.abs() / (70.0 * cst.deg_to_rad), 0.0, 1.0)
    Tair_c = Tair_c * w ** 2 + 15.0 * (1.0 - w)
    TairK = (Tair_c + cst.Tffresh).to(dt)
    Qa = 0.8 * qa_saturation(TairK, fc.rhoa)
    flw = longwave_rosati_miyakoda(TairK, TairK, Qa, cldf)
    swvdr, swvdf, swidr, swidf = shortwave_bands(fsw.to(dt))
    snow = _full(grid, 3.0e-6, dt)      # ~0.26 mm/day of snow or rain
    return fc.replace(Tair=TairK, potT=TairK, Qa=Qa.to(dt), flw=flw.to(dt),
                      swvdr=swvdr, swvdf=swvdf, swidr=swidr, swidf=swidf,
                      fsnow=torch.where(TairK < cst.Tffresh, snow, 0.0),
                      frain=torch.where(TairK >= cst.Tffresh, snow, 0.0),
                      coszen=coszen.to(dt))


# ---------------------------------------------------------------------------
# file datasets
# ---------------------------------------------------------------------------

def prepare_forcing(grid, cfg, raw: dict, fc: Forcing, yday: float) -> Forcing:
    """The full forcing set from raw dataset fields (reference
    prepare_forcing ice_forcing.F90:1603): humidity caps, SW band split,
    longwave closure, precipitation units and the rain/snow partition,
    wind speed, geographic-to-grid rotation."""
    dt = fc.Tair.dtype
    get = lambda k, dflt: raw[k].to(dt) if k in raw else dflt
    TairK = torch.clamp(get("Tair", fc.Tair), min=150.0)
    uatm = get("uatm", fc.uatm)
    vatm = get("vatm", fc.vatm)
    wind = torch.sqrt(uatm ** 2 + vatm ** 2)
    rhoa = fc.rhoa
    Qa = get("Qa", None)
    if Qa is None:
        Qa = 0.8 * qa_saturation(TairK, rhoa)
    Qa = torch.clamp(Qa, min=0.0)
    Qa = torch.minimum(Qa, qa_saturation(TairK, rhoa))
    cldf = get("cldf", _full(grid, 0.5, dt))
    if "swdn" in raw:
        fsw = get("swdn", None)
    elif "fsw" in raw:
        fsw = get("fsw", None)
    else:
        # clear-sky + cloud correction from the daily-mean coszen
        coszen, eccf = default_coszen(grid, yday, cfg=cfg)
        fsw = 1365.0 * eccf * 0.7 * coszen * (1.0 - 0.6 * cldf)
    fsw = torch.clamp(fsw, min=0.0)
    swvdr, swvdf, swidr, swidf = shortwave_bands(fsw.to(dt))
    flw = get("flw", None)
    if flw is None:
        flw = longwave_rosati_miyakoda(TairK, TairK, Qa, cldf)
    # the total precipitation rate in forcing_nml precip_units, split into
    # snow and rain by the air temperature
    prec = get("fsnow", _full(grid, 0.0, dt))
    pu = cfg.forcing.precip_units
    if pu == "mm_per_day":
        prec = prec / cst.secday
    elif pu == "mm_per_month":
        prec = prec / (30.0 * cst.secday)
    elif pu not in ("mks", "mm_per_sec"):
        raise ValueError(f"unknown precip_units '{pu}'")
    fsnow = torch.where(TairK < cst.Tffresh, prec, 0.0)
    frain = torch.where(TairK >= cst.Tffresh, prec, 0.0)
    if cfg.forcing.rotate_wind:
        # file winds are zonal/meridional: rotate into grid x/y
        ca, sa = torch.cos(grid.ANGLET), torch.sin(grid.ANGLET)
        uatm, vatm = uatm * ca + vatm * sa, vatm * ca - uatm * sa
    coszen, _ = default_coszen(grid, yday, cfg=cfg)
    return fc.replace(
        Tair=TairK.to(dt), potT=TairK.to(dt), Qa=Qa.to(dt),
        uatm=uatm.to(dt), vatm=vatm.to(dt), wind=wind.to(dt),
        flw=flw.to(dt), swvdr=swvdr, swvdf=swvdf, swidr=swidr,
        swidf=swidf, fsnow=fsnow.to(dt), frain=frain.to(dt),
        coszen=coszen.to(dt))


def file_ocn(grid, cfg, raw: dict, fc: Forcing) -> Forcing:
    """Ocean forcing from a climatology dataset (reference ocn_data_ncar)."""
    dt = fc.sss.dtype
    get = lambda k, dflt: raw[k].to(dt) if k in raw else dflt
    sss = torch.clamp(get("sss", fc.sss), min=0.0)
    Tf = freezing_temperature(sss, cfg.thermo.tfrz_option)
    uocn, vocn = get("uocn", fc.uocn), get("vocn", fc.vocn)
    if cfg.forcing.rotate_wind:
        ca, sa = torch.cos(grid.ANGLET), torch.sin(grid.ANGLET)
        uocn, vocn = uocn * ca + vocn * sa, vocn * ca - uocn * sa
    return fc.replace(
        sss=sss, Tf=Tf, sst_data=torch.maximum(get("sst", fc.sst_data), Tf),
        uocn=uocn, vocn=vocn, qdp=get("qdp", fc.qdp),
        hmix=torch.clamp(get("hmix", fc.hmix), min=5.0))


def open_dataset(cfg, grid, kind: str):
    """The dataset of one stream (reference init_forcing_atmo): `kind` is
    an atmosphere name of FILE_ATM, 'hycom' or 'ocn' (the climatology)."""
    from ..io import forcing_files as ff
    shp = grid.global_shape
    f = cfg.forcing
    if kind == "ncar":
        ds = ff.ncar_dataset(f.atm_data_dir, shp, f.fyear_init, f.ycycle)
    elif kind == "jra55":
        ds = ff.jra55_dataset(f.atm_data_dir, shp, f.fyear_init, f.ycycle)
    elif kind == "monthly":
        ds = ff.monthly_dataset(f.atm_data_dir, shp, f.fyear_init, f.ycycle)
    elif kind == "hadgem":
        ds = ff.hadgem_dataset(f.atm_data_dir, shp, f.fyear_init, f.ycycle)
    elif kind == "oned":
        ds = ff.oned_dataset(f.atm_data_dir, shp)
    elif kind == "ISPOL":
        ds = ff.ispol_dataset(f.atm_data_dir, shp)
    elif kind == "hycom":
        ds = ff.hycom_ocean_dataset(f.ocn_data_dir, shp, f.fyear_init)
    else:
        ds = ff.ocean_clim_dataset(f.ocn_data_dir, shp, f.fyear_init)
    # leap-aware record addressing follows the model calendar
    ds.calendar_type = cfg.setup.calendar_type
    ds.device = grid.device
    return ds


def default_ocn(grid, cfg, fc: Forcing) -> Forcing:
    sss = _full(grid, 34.0, fc.sss.dtype)
    Tf = freezing_temperature(sss, cfg.thermo.tfrz_option)
    return fc.replace(sss=sss, Tf=Tf)


# ---------------------------------------------------------------------------
# the per-step forcing (get_forcing_atmo / get_forcing_ocn analogue)
# ---------------------------------------------------------------------------

def get_forcing(cfg, grid, timesecs: float, yday: float, aice,
                fc: Forcing | None = None, year: int | None = None,
                sec_of_year: float | None = None, *,
                datasets: dict) -> Forcing:
    """The Forcing at the current time, in the JAX package's order of
    branches. `year`/`sec_of_year` from the model Calendar address the file
    datasets (leap-aware); without them a noleap reconstruction from
    `timesecs` applies. `datasets` holds the open datasets by stream
    between calls (`Model.datasets`); a stream not in it is opened into
    it. An unknown atmosphere or ocean type leaves those fields as
    they are, as in the JAX package (`ocn_data_type='none'`, or 'clim'
    without a directory, keeps the default ocean)."""
    if year is None:
        year = cfg.setup.year_init + int(timesecs // (365.0 * cst.secday))
    if sec_of_year is None:
        sec_of_year = timesecs % (365.0 * cst.secday)
    if fc is None:
        fc = zeros_forcing(grid.shape, cfg.np_dtype, grid.device)
        fc = default_ocn(grid, cfg, fc)
    def dataset(kind):
        if kind not in datasets:
            datasets[kind] = open_dataset(cfg, grid, kind)
        return datasets[kind]

    f = cfg.forcing
    atm = f.atm_data_type
    if atm == "box2001":
        fc = box2001_atm(grid, timesecs, aice, fc)
    elif atm in UNIFORM:
        fc = uniform_atm(grid, atm, 5.0, aice, fc)
    elif atm in FILE_ATM and f.atm_data_dir:
        raw = _tiles(grid, dataset(atm).at_time(year, sec_of_year))
        fc = prepare_forcing(grid, cfg, raw, fc, yday)
        if "strax" in raw:      # hadgem: prescribed wind stress
            dt_ = fc.strax.dtype
            fc = fc.replace(strax=raw["strax"].to(dt_),
                            stray=raw["stray"].to(dt_))
    elif atm == "seasonal" or atm in FILE_ATM:
        # dataset atmospheres without files fall back to the annual cycle
        fc = seasonal_atm(grid, yday, fc)
        fc = uniform_atm(grid, "uniform_east", 5.0, aice, fc)
        fc = fc.replace(wind=torch.clamp(fc.wind, min=1.0))
    ocn = f.ocn_data_type
    if ocn == "box2001":
        fc = box2001_ocn(grid, fc)
    elif ocn in ("clim", "ncar", "hycom") and f.ocn_data_dir:
        ds = dataset("hycom" if ocn == "hycom" else "ocn")
        fc = file_ocn(grid, cfg, _tiles(grid, ds.at_time(year, sec_of_year)),
                      fc)
    wst = f.wave_spec_type
    if wst == "file" and f.wave_spec_file:
        # a wave model's spectrum E(f), read per month; Hs and Tp from its
        # spectral moments
        if "wave" not in datasets:
            from ..io.forcing_files import wave_spec_dataset
            datasets["wave"] = wave_spec_dataset(f.wave_spec_file,
                                                 grid.global_shape,
                                                 grid.device)
        month = int(yday // 30.4) % 12 + 1
        dt_ = fc.wind.dtype
        E = _tiles(grid, {"E": datasets["wave"].at_month(month)})["E"].to(
            dt_)
        fr, df = wave_frequencies(dt_, E.device)
        m0 = lsum(E * df[:, None, None], dim=0)
        m1 = lsum(E * (fr * df)[:, None, None], dim=0)
        hs = 4.0 * torch.sqrt(m0)
        Tp = torch.where(m1 > 0.0, m0 / torch.clamp(m1, min=1e-12), 8.0)
        fc = fc.replace(wave_spectrum=E, wave_hs=hs, wave_Tp=Tp)
    elif wst != "none":
        fc = wave_spectrum_forcing(cfg, grid, aice, fc)
    return fc.replace(yday=torch.tensor(yday, dtype=fc.wind.dtype,
                                        device=fc.wind.device))


# ---------------------------------------------------------------------------
# ocean surface wave spectrum (reference get_wave_spec, ice_forcing.F90:
# the 25-frequency E(f) that icepack_step_wavefracture reads)
# ---------------------------------------------------------------------------

NFREQ = 25


def wave_frequencies(dtype=torch.float32, device="cpu"):
    """The 25-bin WW3 frequency grid of the reference's wave files:
    f_k = 0.04118 * 1.1^k Hz with logarithmic bin widths.

    The powers are those of the JAX package in each dtype, whatever the
    device: in float32 the float32 power (a float64 power rounded to
    float32 differs in the last bit, and the FSD's fracture marks follow
    it), taken on the CPU; in float64 the correctly rounded libm power
    (math.pow), which XLA's equals and torch.pow's does not at k=10."""
    return _wave_frequencies(dtype, torch.device(device))


@functools.lru_cache(maxsize=None)
def _wave_frequencies(dtype, device):
    if dtype == torch.float64:
        p = torch.tensor([math.pow(1.1, k) for k in range(NFREQ)],
                         dtype=dtype)
    else:
        p = torch.pow(1.1, torch.arange(NFREQ, dtype=dtype))
    f = 0.04118 * p.to(device)
    df = f * (1.1 ** 0.5 - 1.1 ** -0.5)
    return f, df


def bretschneider_spectrum(hs, Tp):
    """Bretschneider (modified Pierson-Moskowitz) spectrum
    E(f) = (5/16) Hs^2 fp^4 f^-5 exp(-5/4 (fp/f)^4) [m^2/Hz] on the 25-bin
    grid; it integrates back to Hs = 4 sqrt(m0)."""
    f, _ = wave_frequencies(hs.dtype, hs.device)
    fp = 1.0 / torch.clamp(Tp, min=1.0)
    fr = fp[None] / f[:, None, None]          # fp/f
    return (5.0 / 16.0) * (hs[None] ** 2) * fr ** 4 / f[:, None, None] * \
        torch.exp(-1.25 * fr ** 4)


def wave_spectrum_forcing(cfg, grid, aice, fc: Forcing) -> Forcing:
    """In-ice wave state: a fully developed local-wind sea (Hs = 0.0248
    U^2, Tp = 0.729 U; Pierson & Moskowitz 1964) over the open-water
    fraction, expanded to the 25-frequency spectrum."""
    hs = 0.0248 * fc.wind ** 2 * torch.clamp(1.0 - aice, 0.0, 1.0)
    Tp = torch.clamp(0.729 * fc.wind, min=2.0)
    E = bretschneider_spectrum(hs, Tp)
    _, df = wave_frequencies(E.dtype, E.device)
    m0 = lsum(E * df[:, None, None], dim=0)
    return fc.replace(wave_hs=4.0 * torch.sqrt(m0), wave_Tp=Tp,
                      wave_spectrum=E)
