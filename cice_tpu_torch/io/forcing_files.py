"""File-based forcing datasets: record readers and time interpolation
(PyTorch port of cice_tpu/io/forcing_files.py; reference ice_forcing.F90
`JRA55_files`:2181, `ncar_files`, `ice_read_xyt` ice_read_write.F90:198,
`interp_coeff`:1341-1488, `interpolate_data`:1492, `read_data`:756).

Containers:
- `.npz`: a dict of `(nrec, ny, nx)` arrays keyed by field name;
- `.nc`: netCDF3-classic through scipy, CF scale/offset applied;
- `.bin`: big-endian float64 direct-access records in field-major order.

Each record is read once. A dataset keeps its files open
(`RecordReader`): a netCDF file is memory-mapped and only the requested
record is copied out, an npz member is decompressed once per file. The
two records that bracket the model time stay on the device as float64
tensors; `at_time` interpolates there (`c1 * r1 + c2 * r2`, two separate
kernels, so no fused multiply-add: the same rounding as the JAX package's
NumPy interpolation on the host), and the caller casts to the state dtype.
So the host uploads one record per field when the bracket moves, not
every step.

`WaveSpecDataset` reads a wave model's monthly 25-frequency spectra
(wave_spec_type='file') and keeps the current month on the device.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

SECDAY = 86400.0
DAYYR = 365.0


# ---------------------------------------------------------------------------
# record readers
# ---------------------------------------------------------------------------

class RecordReader:
    """Open forcing files, one handle per path, and single-record reads.
    `close()` releases them."""

    def __init__(self):
        self._nc: dict = {}
        self._npz: dict = {}

    def read(self, path: str, varname: str, nrec: int, shape,
             total_recs: Optional[int] = None) -> np.ndarray:
        """Record `nrec` (0-based) of `varname` in `path` as float64
        (reference ice_read_xyt / ice_read_nc_xy)."""
        if path.endswith(".npz"):
            members = self._npz.setdefault(path, {})
            if varname not in members:
                with np.load(path) as z:
                    members[varname] = z[varname]
            return np.asarray(members[varname][nrec], np.float64)
        if path.endswith(".nc"):
            return self._read_nc(path, varname, nrec)
        if path.endswith(".bin"):
            # field-major big-endian f64: all records of field 0, then
            # field 1...; varname is the field's index in the file
            ny, nx = shape
            recsize = ny * nx * 8
            ntot = total_recs if total_recs else 1
            off = (int(varname) * ntot + nrec) * recsize
            with open(path, "rb") as f:
                f.seek(off)
                buf = f.read(recsize)
            return np.frombuffer(buf, ">f8").reshape(ny, nx).astype(
                np.float64)
        raise ValueError(f"unknown forcing container: {path}")

    def _read_nc(self, path: str, varname: str, nrec: int) -> np.ndarray:
        from scipy.io import netcdf_file
        f = self._nc.get(path)
        if f is None:
            f = self._nc[path] = netcdf_file(path, "r", mmap=True)
        shp = f.variables[varname].shape
        if len(shp) == 3 and nrec >= shp[0]:
            raise ValueError(
                f"forcing record {nrec} is beyond the {shp[0]} records of "
                f"'{varname}' in {path} — the run window exceeds the "
                "materialized forcing (fixture files carry a limited "
                "record window; regenerate with more records or start/stop "
                "the run inside the window)")
        # no reference to the variable may outlive the call: a live one
        # keeps the memory map open when the reader closes
        v = f.variables[varname]
        out = np.array(v[nrec] if len(shp) == 3 else v[:], np.float64)
        sf = getattr(v, "scale_factor", None)
        ao = getattr(v, "add_offset", None)
        if sf is not None:
            out = out * float(sf)
        if ao is not None:
            out = out + float(ao)
        return out

    def close(self) -> None:
        for f in self._nc.values():
            f.close()
        self._nc.clear()
        self._npz.clear()


# ---------------------------------------------------------------------------
# time interpolation (reference interp_coeff / interpolate_data)
# ---------------------------------------------------------------------------

def interp_coeff(timesecs: float, recslot: int, secint: float,
                 offset: float = 0.0):
    """Linear weights (c1, c2) between bracketing records (reference
    interp_coeff ice_forcing.F90:1436): records are centred at
    (rec - 0.5) * secint + offset; `recslot` is the record after
    `timesecs`."""
    t2 = (recslot - 0.5) * secint + offset
    t1 = t2 - secint
    c2 = (timesecs - t1) / secint
    c2 = min(max(c2, 0.0), 1.0)
    return 1.0 - c2, c2


@dataclass
class ForcingDataset:
    """One time-varying forcing stream (NCAR monthly, JRA55 3-hourly...):
    the bracketing records on the device and their interpolation."""

    path_pattern: str            # e.g. "{dir}/JRA55_{year:04d}.nc"
    fields: Dict[str, str]       # model field -> file variable name
    secint: float                # seconds between records
    data_dir: str = ""
    fyear_init: int = 2005
    ycycle: int = 1              # years in the forcing cycle
    offset: float = 0.0          # record-centre offset (s)
    shape: tuple = (0, 0)
    calendar_type: str = "noleap"   # 'gregorian': leap-year record counts
    device: str = "cpu"
    records_read: int = 0        # records read from files (all fields)
    read_seconds: float = 0.0    # host time spent reading and uploading
    _cache: dict = field(default_factory=dict)
    _reader: RecordReader = field(default_factory=RecordReader)

    def days_in_year(self, year: int) -> float:
        if self.calendar_type == "gregorian" and (
                year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)):
            return 366.0
        if self.calendar_type == "360day":
            return 360.0
        return DAYYR

    def n_per_year(self, year: int | None = None) -> int:
        d = DAYYR if year is None else self.days_in_year(year)
        return int(round(d * SECDAY / self.secint))

    def _file_for(self, year: int) -> str:
        cyc_year = self.fyear_init + (year - self.fyear_init) % self.ycycle
        return self.path_pattern.format(dir=self.data_dir, year=cyc_year)

    def _read_rec(self, year: int, rec: int) -> Dict[str, torch.Tensor]:
        # wrap records across year boundaries (per-year record counts: a
        # 3-hourly gregorian stream has 2928 records in leap years)
        while rec < 0:
            year -= 1
            rec += self.n_per_year(year)
        while rec >= self.n_per_year(year):
            rec -= self.n_per_year(year)
            year += 1
        npy = self.n_per_year(year)
        key = (self._file_for(year), rec)
        if key not in self._cache:
            t0 = time.perf_counter()
            out = {name: torch.as_tensor(
                self._reader.read(key[0], var, rec, self.shape,
                                  total_recs=npy), device=self.device)
                   for name, var in self.fields.items()}
            # the bracket moves forward: keep the newest few records
            if len(self._cache) > 2:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = out
            self.records_read += 1
            self.read_seconds += time.perf_counter() - t0
        return self._cache[key]

    def at_time(self, year: int,
                sec_of_year: float) -> Dict[str, torch.Tensor]:
        """Interpolated float64 fields at (`year`, seconds since Jan 1).
        0-based record r is centred at (r + 0.5) * secint; `r_after` is the
        first record centred at or after the requested time."""
        r_after = int(np.floor((sec_of_year - self.offset) / self.secint +
                               0.5))
        c1, c2 = interp_coeff(sec_of_year, r_after + 1, self.secint,
                              self.offset)
        r1 = self._read_rec(year, r_after - 1)
        r2 = self._read_rec(year, r_after)
        return {k: c1 * r1[k] + c2 * r2[k] for k in self.fields}

    def close(self) -> None:
        self._reader.close()
        self._cache.clear()


# ---------------------------------------------------------------------------
# dataset definitions (reference ncar_files / JRA55_files)
# ---------------------------------------------------------------------------

MONTH = DAYYR * SECDAY / 12.0


def ncar_dataset(data_dir: str, shape, fyear_init=2005,
                 ycycle=1) -> ForcingDataset:
    """NCAR bulk monthly forcing (reference ncar_data ice_forcing.F90:2023)."""
    return ForcingDataset(
        path_pattern="{dir}/ncar_bulk_{year:04d}.npz",
        fields=dict(Tair="Tair", Qa="Qa", uatm="uatm", vatm="vatm",
                    fsw="fsw", cldf="cldf", fsnow="fsnow"),
        secint=MONTH, data_dir=data_dir, fyear_init=fyear_init,
        ycycle=ycycle, shape=shape)


def jra55_dataset(data_dir: str, shape, fyear_init=2005,
                  ycycle=1) -> ForcingDataset:
    """JRA55(do) 3-hourly forcing (reference JRA55_data:2305)."""
    return ForcingDataset(
        path_pattern="{dir}/JRA55_{year:04d}.nc",
        fields=dict(Tair="airtmp", Qa="spchmd", uatm="wndewd",
                    vatm="wndnwd", swdn="glbrad", flw="dlwsfc",
                    fsnow="ttlpcp"),
        secint=3.0 * 3600.0, data_dir=data_dir, fyear_init=fyear_init,
        ycycle=ycycle, shape=shape)


def ocean_clim_dataset(data_dir: str, shape,
                       fyear_init=2005) -> ForcingDataset:
    """Monthly ocean climatology (reference ocn_data_ncar)."""
    return ForcingDataset(
        path_pattern="{dir}/ocean_clim.npz",
        fields=dict(sst="sst", sss="sss", uocn="uocn", vocn="vocn",
                    qdp="qdp", hmix="hmix"),
        secint=MONTH, data_dir=data_dir, fyear_init=fyear_init, ycycle=1,
        shape=shape)


def monthly_dataset(data_dir: str, shape, fyear_init=2005,
                    ycycle=1) -> ForcingDataset:
    """Monthly climatology atmosphere (reference monthly_data)."""
    return ForcingDataset(
        path_pattern="{dir}/monthly_clim.npz",
        fields=dict(Tair="Tair", Qa="Qa", uatm="uatm", vatm="vatm",
                    cldf="cldf", fsnow="fsnow"),
        secint=MONTH, data_dir=data_dir, fyear_init=fyear_init,
        ycycle=ycycle, shape=shape)


def hadgem_dataset(data_dir: str, shape, fyear_init=2005,
                   ycycle=1) -> ForcingDataset:
    """HadGEM3 monthly forcing with a prescribed wind stress (reference
    hadgem_data)."""
    return ForcingDataset(
        path_pattern="{dir}/MONTHLY/hadgem_{year:04d}.nc",
        fields=dict(Tair="airtmp", Qa="spchmd", strax="taux", stray="tauy",
                    uatm="u10", vatm="v10", swdn="swdn", flw="lwdn",
                    fsnow="snowfall", frain="rainfall"),
        secint=MONTH, data_dir=data_dir, fyear_init=fyear_init,
        ycycle=ycycle, shape=shape)


def hycom_ocean_dataset(data_dir: str, shape,
                        fyear_init=2005) -> ForcingDataset:
    """HYCOM daily ocean forcing (reference ocn_data_hycom_init)."""
    return ForcingDataset(
        path_pattern="{dir}/hycom_ocn_{year:04d}.nc",
        fields=dict(sst="sst", sss="sss", uocn="uvel", vocn="vvel"),
        secint=SECDAY, data_dir=data_dir, fyear_init=fyear_init, ycycle=1,
        shape=shape)


# ---------------------------------------------------------------------------
# point time series (oned / ISPOL): one value per record and field,
# broadcast to the grid (reference oned_data / ISPOL_data)
# ---------------------------------------------------------------------------

@dataclass
class PointSeriesDataset:
    """Scalar time series broadcast to the grid; container: npz of 1-D
    arrays keyed by field."""

    path: str
    fields: Dict[str, str]
    secint: float
    shape: tuple = (0, 0)
    device: str = "cpu"
    _data: Optional[dict] = None

    def _load(self) -> dict:
        if self._data is None:
            with np.load(self.path) as z:
                self._data = {k: np.asarray(z[v], np.float64)
                              for k, v in self.fields.items() if v in z}
        return self._data

    def at_time(self, year: int,
                sec_of_year: float) -> Dict[str, torch.Tensor]:
        out = {}
        for k, series in self._load().items():
            n = series.size
            r_after = int(np.floor(sec_of_year / self.secint + 0.5))
            c1, c2 = interp_coeff(sec_of_year, r_after + 1, self.secint)
            v = c1 * series[(r_after - 1) % n] + c2 * series[r_after % n]
            out[k] = torch.full(tuple(self.shape), float(v),
                                dtype=torch.float64, device=self.device)
        return out

    def close(self) -> None:
        self._data = None


def oned_dataset(data_dir: str, shape) -> PointSeriesDataset:
    """Single-point hourly forcing (reference oned_data)."""
    return PointSeriesDataset(
        path=os.path.join(data_dir, "oned_forcing.npz"),
        fields=dict(Tair="Tair", Qa="Qa", uatm="uatm", vatm="vatm",
                    fsw="fsw", flw="flw", fsnow="fsnow"),
        secint=3600.0, shape=shape)


def ispol_dataset(data_dir: str, shape) -> PointSeriesDataset:
    """ISPOL Weddell-Sea field-campaign series, 6-hourly (reference
    ISPOL_data)."""
    return PointSeriesDataset(
        path=os.path.join(data_dir, "ispol_forcing.npz"),
        fields=dict(Tair="Tair", Qa="Qa", uatm="uatm", vatm="vatm",
                    fsw="fsw", flw="flw", fsnow="fsnow"),
        secint=6.0 * 3600.0, shape=shape)


# ---------------------------------------------------------------------------
# ocean-surface wave spectrum dataset (reference get_wave_spec,
# ice_forcing.F90: wave_spec_type='file' reads `wave_spec_file`, a monthly
# 25-frequency E(f) wave-model product for the FSD fracture)
# ---------------------------------------------------------------------------

@dataclass
class WaveSpecDataset:
    """Monthly (12, nfreq, ny, nx), or static (nfreq, ny, nx), `efreq`
    spectra [m^2/Hz] read as float32 (the file's precision, as in the JAX
    package). `at_month` returns the month's planes as a float32 tensor
    on `device`; the last month stays there, so a month is uploaded
    once."""

    path: str
    shape: tuple
    device: str = "cpu"
    _data: Optional[np.ndarray] = None
    _month: Optional[tuple] = None

    def _load(self) -> np.ndarray:
        if self._data is None:
            if self.path.endswith(".npz"):
                with np.load(self.path) as z:
                    self._data = np.asarray(z["efreq"], np.float32)
            else:
                from scipy.io import netcdf_file
                with netcdf_file(self.path, "r", mmap=False) as f:
                    self._data = np.array(f.variables["efreq"][:],
                                          np.float32)
            if self._data.shape[-2:] != tuple(self.shape):
                raise ValueError(
                    f"wave_spec_file grid {self._data.shape[-2:]} != "
                    f"model grid {tuple(self.shape)}")
        return self._data

    def at_month(self, month: int) -> torch.Tensor:
        d = self._load()
        slot = 0 if d.ndim == 3 else (month - 1) % d.shape[0]
        if self._month is None or self._month[0] != slot:
            plane = d if d.ndim == 3 else d[slot]
            self._month = (slot, torch.as_tensor(plane, device=self.device))
        return self._month[1]


def wave_spec_dataset(path: str, shape, device="cpu") -> WaveSpecDataset:
    return WaveSpecDataset(path=path, shape=tuple(shape), device=device)
