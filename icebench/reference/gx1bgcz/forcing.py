"""The file forcing of the configurations this reference carries: the
NCAR bulk monthly atmosphere and the monthly ocean climatology, read from
the program's `.npz` layout (a frozen copy of the program's
io/forcing_files.py and model/forcing.py, cut to those two streams;
reference ice_forcing.F90 `ncar_data`:2023, `ocn_data_ncar`,
`interp_coeff`:1436, `prepare_forcing`:1603).

A dataset keeps the two records that bracket the model time as float64
tensors on the device and interpolates there (`c1 * r1 + c2 * r2`); the
fields are then cast to the state's dtype.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..ice import constants as cst
from ..ice.columns.ocean import freezing_temperature
from ..ice.model.flux import Forcing, zeros_forcing
from ..ice.model.forcing import default_ocn
from .columns.orbit import OrbitalParams, compute_coszen, orb_params

SECDAY = 86400.0
DAYYR = 365.0
MONTH = DAYYR * SECDAY / 12.0

#: model field -> file variable, by stream
NCAR_FIELDS = dict(Tair="Tair", Qa="Qa", uatm="uatm", vatm="vatm",
                   fsw="fsw", cldf="cldf", fsnow="fsnow")
OCN_FIELDS = dict(sst="sst", sss="sss", uocn="uocn", vocn="vocn",
                  qdp="qdp", hmix="hmix")


def interp_coeff(timesecs: float, recslot: int, secint: float,
                 offset: float = 0.0):
    """Linear weights (c1, c2) between bracketing records: records are
    centred at (rec - 0.5) * secint + offset; `recslot` is the record after
    `timesecs`."""
    t2 = (recslot - 0.5) * secint + offset
    t1 = t2 - secint
    c2 = (timesecs - t1) / secint
    c2 = min(max(c2, 0.0), 1.0)
    return 1.0 - c2, c2


class MonthlyDataset:
    """One monthly stream of `.npz` files (12 records a year): the
    bracketing records on the device and their interpolation."""

    def __init__(self, path_pattern: str, fields: dict, data_dir: str,
                 fyear_init: int, ycycle: int, device):
        self.path_pattern, self.fields = path_pattern, fields
        self.data_dir, self.device = data_dir, device
        self.fyear_init, self.ycycle = fyear_init, ycycle
        self._files: dict = {}
        self._cache: dict = {}

    def _file_for(self, year: int) -> str:
        cyc = self.fyear_init + (year - self.fyear_init) % self.ycycle
        return self.path_pattern.format(dir=self.data_dir, year=cyc)

    def _member(self, path: str, var: str) -> np.ndarray:
        members = self._files.setdefault(path, {})
        if var not in members:
            with np.load(path) as z:
                members[var] = z[var]
        return members[var]

    def _read_rec(self, year: int, rec: int) -> Dict[str, torch.Tensor]:
        while rec < 0:
            year -= 1
            rec += 12
        while rec >= 12:
            rec -= 12
            year += 1
        key = (self._file_for(year), rec)
        if key not in self._cache:
            out = {name: torch.as_tensor(
                np.asarray(self._member(key[0], var)[rec], np.float64),
                device=self.device) for name, var in self.fields.items()}
            if len(self._cache) > 2:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = out
        return self._cache[key]

    def at_time(self, year: int, sec_of_year: float):
        """Interpolated float64 fields at (`year`, seconds since Jan 1)."""
        r_after = int(np.floor(sec_of_year / MONTH + 0.5))
        c1, c2 = interp_coeff(sec_of_year, r_after + 1, MONTH)
        r1 = self._read_rec(year, r_after - 1)
        r2 = self._read_rec(year, r_after)
        return {k: c1 * r1[k] + c2 * r2[k] for k in self.fields}


def open_datasets(cfg, device) -> dict:
    """{'ncar': the atmosphere, 'ocn': the ocean climatology}."""
    f = cfg.forcing
    return {
        "ncar": MonthlyDataset(os.path.join("{dir}", "ncar_bulk_{year:04d}"
                                            ".npz"), NCAR_FIELDS,
                               f.atm_data_dir, f.fyear_init, f.ycycle,
                               device),
        "ocn": MonthlyDataset(os.path.join("{dir}", "ocean_clim.npz"),
                              OCN_FIELDS, f.ocn_data_dir, f.fyear_init, 1,
                              device)}


def orbital_from_cfg(cfg) -> OrbitalParams:
    """Orbital parameters from the config (orb_mode)."""
    f = cfg.forcing
    if f.orb_mode == "fixed_parameters":
        return OrbitalParams(eccen=f.orb_eccen, obliq=f.orb_obliq,
                             mvelp=f.orb_mvelp)
    if f.orb_mode != "fixed_year":
        raise ValueError(f"orb_mode={f.orb_mode!r}: expected 'fixed_year' "
                         "or 'fixed_parameters'")
    return orb_params(f.orb_iyear)


def shortwave_bands(fsw):
    """(vdr, vdf, idr, idf) of the net incoming SW."""
    return (fsw * 0.28, fsw * 0.24, fsw * 0.31, fsw * 0.17)


def qa_saturation(Tair_K, rhoa):
    """Saturation specific humidity over water at Tair."""
    return (cst.qqqocn / torch.clamp(rhoa, min=1e-8)) * \
        torch.exp(-cst.TTTocn / Tair_K)


def longwave_rosati_miyakoda(Tair_K, cldf):
    """Downward longwave (W/m^2), Rosati & Miyakoda (1988) (reference
    ice_forcing.F90:1847)."""
    fcc = 1.0 - 0.8 * cldf
    ptem = Tair_K
    return (cst.stefan_boltzmann * ptem ** 4
            * (1.0 - 0.261 * torch.exp(-7.77e-4 * (273.0 - ptem) ** 2))
            * fcc)


def prepare_forcing(grid, cfg, raw: dict, fc: Forcing,
                    yday: float) -> Forcing:
    """The full forcing set from an NCAR record: humidity caps, SW band
    split, longwave closure, precipitation units and the rain/snow
    partition, wind speed, geographic-to-grid rotation."""
    dt = fc.Tair.dtype
    get = lambda k: raw[k].to(dt)
    TairK = torch.clamp(get("Tair"), min=150.0)
    uatm, vatm = get("uatm"), get("vatm")
    wind = torch.sqrt(uatm ** 2 + vatm ** 2)
    rhoa = fc.rhoa
    Qa = torch.clamp(get("Qa"), min=0.0)
    Qa = torch.minimum(Qa, qa_saturation(TairK, rhoa))
    cldf = get("cldf")
    fsw = torch.clamp(get("fsw"), min=0.0)
    swvdr, swvdf, swidr, swidf = shortwave_bands(fsw.to(dt))
    flw = longwave_rosati_miyakoda(TairK, cldf)
    prec = get("fsnow")
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
        ca, sa = torch.cos(grid.ANGLET), torch.sin(grid.ANGLET)
        uatm, vatm = uatm * ca + vatm * sa, vatm * ca - uatm * sa
    coszen, _ = compute_coszen(grid.TLAT, grid.TLON, yday,
                               orbital_from_cfg(cfg), daily_mean=True)
    return fc.replace(
        Tair=TairK.to(dt), potT=TairK.to(dt), Qa=Qa.to(dt),
        uatm=uatm.to(dt), vatm=vatm.to(dt), wind=wind.to(dt),
        flw=flw.to(dt), swvdr=swvdr, swvdf=swvdf, swidr=swidr,
        swidf=swidf, fsnow=fsnow.to(dt), frain=frain.to(dt),
        coszen=coszen.to(dt))


def file_ocn(grid, cfg, raw: dict, fc: Forcing) -> Forcing:
    """Ocean forcing from the climatology (reference ocn_data_ncar)."""
    dt = fc.sss.dtype
    get = lambda k: raw[k].to(dt)
    sss = torch.clamp(get("sss"), min=0.0)
    Tf = freezing_temperature(sss, cfg.thermo.tfrz_option)
    uocn, vocn = get("uocn"), get("vocn")
    if cfg.forcing.rotate_wind:
        ca, sa = torch.cos(grid.ANGLET), torch.sin(grid.ANGLET)
        uocn, vocn = uocn * ca + vocn * sa, vocn * ca - uocn * sa
    return fc.replace(
        sss=sss, Tf=Tf, sst_data=torch.maximum(get("sst"), Tf),
        uocn=uocn, vocn=vocn, qdp=get("qdp"),
        hmix=torch.clamp(get("hmix"), min=5.0))


def initial_forcing(cfg, grid) -> Forcing:
    """The forcing before the first step: zeros and the default ocean."""
    fc = zeros_forcing(grid.shape, cfg.np_dtype, grid.device)
    return default_ocn(grid, cfg, fc)


def get_forcing(cfg, grid, datasets: dict, year: int, sec_of_year: float,
                yday: float, fc: Forcing) -> Forcing:
    """The forcing at (`year`, `sec_of_year`) over `fc`: the NCAR
    atmosphere, then the ocean climatology."""
    fc = prepare_forcing(grid, cfg, datasets["ncar"].at_time(
        year, sec_of_year), fc, yday)
    fc = file_ocn(grid, cfg, datasets["ocn"].at_time(year, sec_of_year), fc)
    return fc.replace(yday=torch.tensor(yday, dtype=fc.wind.dtype,
                                        device=fc.wind.device))
