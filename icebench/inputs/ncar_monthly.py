"""Seeded NCAR monthly forcing files in the program's `.npz` layout
(`io/forcing_files.ncar_dataset` and `ocean_clim_dataset`): the
atmosphere `ncar_bulk_<year>.npz` (12 monthly records of `Tair Qa uatm
vatm fsw cldf fsnow`) and the ocean climatology `ocean_clim.npz` (`sst sss
uocn vocn qdp hmix`), written under the run's own directory; nothing is
downloaded.

Each field is a zonal climatological mean of the record's month plus
smooth seeded anomalies (`smooth.py`) that stay fixed through the year.
The air and sea surface temperatures follow the published zonal means cited
at `TAIR_JAN` and `SST_JAN` (January and July, joined by the annual
harmonic); the humidity is a fixed share of saturation by Large & Yeager
(2004)'s formula; the shortwave is the daily-mean insolation through a
cloudy sky. Record 0 is mid-January, so a run from 1 January starts in
the southern summer: the air over the southern pack is near melting and
the water under it at its freezing point, and the melt season of the
Southern Ocean's ice drives the brine column in the first weeks. Winds
are zonal/meridional (the program rotates them to the grid).

The shape is the grid's: it is read from the files of the input that
`"grid"` names (the `displaced_pole_grid` writer names them
`dp<nx>x<ny>_grid.bin`), so a grid shrunk for a test gives files of the
shrunk shape.

params: {"kind": "ncar_monthly", "grid": <input name>, "year": int}
returns: {"atm_dir": path, "ocn_dir": path}
"""

from __future__ import annotations

import os
import re

import numpy as np

from . import smooth

#: the fields of each file, in the program's reader's names
ATM_FIELDS = ("Tair", "Qa", "uatm", "vatm", "fsw", "cldf", "fsnow")
OCN_FIELDS = ("sst", "sss", "uocn", "vocn", "qdp", "hmix")
_GRID_NAME = re.compile(r"dp(\d+)x(\d+)_grid\.bin$")


def grid_latlon(path: str):
    """(TLAT, TLON) in degrees of the displaced-pole grid file `path`: its
    U-point records ULAT, ULON (the first two of the POP binary layout)
    averaged onto T points as the grid's reader does."""
    from ..reference.ice.io.fixtures import _tlatlon
    m = _GRID_NAME.search(os.path.basename(path))
    if m is None:
        raise ValueError(f"{path}: not a displaced_pole_grid file "
                         "(dp<nx>x<ny>_grid.bin)")
    nx, ny = int(m.group(1)), int(m.group(2))
    n = nx * ny
    if os.path.getsize(path) != 7 * 8 * n:
        raise ValueError(f"{path}: {os.path.getsize(path)} bytes, not the "
                         f"7 records of {ny}x{nx}")
    raw = np.fromfile(path, ">f8", count=2 * n).reshape(2, ny, nx)
    tlat, tlon = _tlatlon(raw[0], raw[1])
    return np.rad2deg(tlat), np.rad2deg(tlon)


#: Anchor latitudes (degrees north) of the zonal means below.
LAT = (-90.0, -78.0, -70.0, -65.0, -60.0, -55.0, -50.0, -40.0, -30.0,
       -20.0, 0.0, 20.0, 30.0, 40.0, 50.0, 60.0, 70.0, 80.0, 90.0)

#: Zonal-mean near-surface air temperature (degrees C) over the ocean and
#: the sea ice in January and in July, at `LAT`, after the NCEP/NCAR
#: reanalysis climatology (Kalnay et al. 1996, Bull. Amer. Meteor. Soc.
#: 77:437-471), on which the CORE forcing that CICE's `ncar` files carry
#: is built (Large & Yeager 2004, NCAR/TN-460+STR): rounded, and good to
#: a few K, since the repository holds no copy of the data to read them
#: from. Over the southern pack in January the air is near the melting
#: point (-1 C at 65S); the central Arctic is near -30 C in January and
#: 0 C, the melting surface, in July.
TAIR_JAN = (-25.0, -8.0, -3.0, -1.0, 0.0, 3.0, 6.0, 15.0, 21.0, 25.0,
            26.0, 23.0, 18.0, 11.0, 3.0, -3.0, -20.0, -29.0, -32.0)
TAIR_JUL = (-45.0, -28.0, -20.0, -13.0, -7.0, -1.0, 3.0, 11.0, 16.0,
            21.0, 26.0, 27.0, 25.0, 21.0, 13.0, 9.0, 3.0, 0.0, -1.0)

#: Zonal-mean sea surface temperature (degrees C) in January and July at
#: `LAT`, after the World Ocean Atlas climatology (Locarnini et al. 2013,
#: NOAA Atlas NESDIS 73): rounded, and good to about 1 K. Where sea ice
#: lies the water is at its freezing point, -1.8 C at the salinities
#: below (the program's reader also raises the SST to its own freezing
#: point).
SST_JAN = (-1.8, -1.8, -1.8, -1.0, 1.0, 3.5, 6.5, 14.0, 21.0, 25.0,
           27.0, 24.0, 19.0, 14.0, 7.0, 4.0, 0.0, -1.8, -1.8)
SST_JUL = (-1.8, -1.8, -1.8, -1.8, -1.5, 1.5, 4.5, 11.0, 17.0, 23.0,
           27.0, 28.0, 24.0, 20.0, 12.0, 8.0, 3.0, -1.5, -1.8)

#: Freezing point of seawater at the stand-in's salinities (degrees C)
T_FREEZE = -1.8
#: Relative humidity of the air, the typical marine value
RH = 0.8
#: Solar constant (W/m^2) and the clear-sky transmission of the
#: atmosphere for the daily-mean downwelling shortwave
S0, TRANSMISSION = 1365.0, 0.75


def _season(lat, month: int, jan, jul):
    """The zonal mean of month `month` (0 = January) at `lat`: the
    January and July anchors joined by the annual harmonic, extreme in
    mid-January and mid-July."""
    doy = (month + 0.5) * 365.0 / 12.0
    w = 0.5 * (1.0 + np.cos(2.0 * np.pi * (doy - 15.0) / 365.0))
    return (w * np.interp(lat, LAT, jan)
            + (1.0 - w) * np.interp(lat, LAT, jul))


def daily_insolation(lat, doy: float):
    """Daily-mean insolation at the top of the atmosphere (W/m^2) at `lat`
    degrees on day of year `doy` on a circular orbit: S0 / pi (h0 sin(lat)
    sin(decl) + cos(lat) cos(decl) sin(h0)), h0 the hour angle of sunset
    (Hartmann 1994, Global Physical Climate, ch. 2); zero in the polar
    night, largest at the summer pole."""
    decl = np.deg2rad(-23.44) * np.cos(2.0 * np.pi * (doy + 10.0) / 365.0)
    phi = np.deg2rad(lat)
    h0 = np.arccos(np.clip(-np.tan(phi) * np.tan(decl), -1.0, 1.0))
    return S0 / np.pi * (h0 * np.sin(phi) * np.sin(decl)
                         + np.cos(phi) * np.cos(decl) * np.sin(h0))


def atmosphere(lat, lon, month: int, anom) -> dict:
    """The atmosphere of month `month` (0 = January) on (lat, lon) in
    degrees; `anom` holds five smooth fields in [0, 1]."""
    doy = (month + 0.5) * 365.0 / 12.0
    latr, lonr = np.deg2rad(lat), np.deg2rad(lon)
    # the zonal mean of the month plus up to +-2 K of seeded anomaly
    Tair = (_season(lat, month, TAIR_JAN, TAIR_JUL) + 273.15
            + 2.0 * (2.0 * anom[0] - 1.0))
    # specific humidity at RH of saturation over seawater, 0.98 *
    # 640380 / rhoa * exp(-5107.4 / T) (Large & Yeager 2004; the
    # reader caps it again at its own saturation)
    Qa = RH * 0.98 * (640380.0 / 1.3) * np.exp(-5107.4 / Tair)
    # westerlies in mid-latitudes, easterlies at the ice edge, +-2 m/s
    phase = 2.0 * np.pi * month / 12.0
    uatm = (6.0 * np.sin(2.0 * latr) ** 2 - 2.0
            + 2.0 * np.cos(3.0 * lonr + phase) + 2.0 * (2.0 * anom[1] - 1.0))
    vatm = (2.0 * np.sin(3.0 * lonr + phase) + np.sin(2.0 * latr)
            + 2.0 * (2.0 * anom[2] - 1.0))
    cldf = np.clip(0.5 + 0.2 * np.sin(latr) ** 2
                   + 0.2 * (2.0 * anom[3] - 1.0), 0.0, 1.0)
    # daily-mean downwelling shortwave: the insolation through a clear
    # sky, less what clouds reflect
    fsw = daily_insolation(lat, doy) * TRANSMISSION * (1.0 - 0.6 * cldf)
    # precipitation (kg/m^2/s), ~1 mm/day with storm-track maxima
    fsnow = 1.0e-5 * (0.4 + 0.6 * np.cos(2.0 * latr) ** 2) * (
        0.5 + anom[4])
    return dict(Tair=Tair, Qa=Qa, uatm=uatm, vatm=vatm, fsw=fsw, cldf=cldf,
                fsnow=fsnow)


def ocean(lat, lon, month: int, anom) -> dict:
    """The ocean climatology of month `month` on (lat, lon) in degrees;
    `anom` holds three smooth fields in [0, 1]."""
    latr, lonr = np.deg2rad(lat), np.deg2rad(lon)
    # the zonal mean of the month, +-0.5 K of seeded anomaly where the
    # water is above freezing, and the freezing point below
    t = _season(lat, month, SST_JAN, SST_JUL)
    t = np.where(t > T_FREEZE, t + 0.5 * (2.0 * anom[0] - 1.0), T_FREEZE)
    return dict(
        sst=np.maximum(t, T_FREEZE),
        sss=34.0 - 2.0 * np.cos(latr) ** 6 + 0.3 * (2.0 * anom[1] - 1.0),
        uocn=0.05 * np.sin(2.0 * latr) + 0.02 * np.cos(2.0 * lonr),
        vocn=0.02 * np.sin(2.0 * lonr),
        qdp=np.full_like(t, -2.0),
        hmix=20.0 + 10.0 * np.cos(latr) ** 2 + 5.0 * anom[2])


def _save(path: str, months: list) -> None:
    arrays = {k: np.stack([m[k] for m in months]).astype(np.float32)
              for k in months[0]}
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def make(params, seed, ctx) -> dict:
    lat, lon = grid_latlon(ctx.made[params.get("grid", "grid")]["grid"])
    year = int(params.get("year", 2005))
    g = smooth.rng(seed, "ncar_monthly")
    a_atm = smooth.field(g, lat.shape, count=5)
    a_ocn = smooth.field(g, lat.shape, count=3)
    d = os.path.join(ctx.run_dir, "forcing")
    os.makedirs(d, exist_ok=True)
    _save(os.path.join(d, f"ncar_bulk_{year:04d}.npz"),
          [atmosphere(lat, lon, m, a_atm) for m in range(12)])
    _save(os.path.join(d, "ocean_clim.npz"),
          [ocean(lat, lon, m, a_ocn) for m in range(12)])
    return {"atm_dir": d, "ocn_dir": d}
