"""Format-true baseline fixtures: gx3/gx1 displaced-pole and tx1 tripole
POP grids and their forcing files (a copy of cice_tpu/io/fixtures.py, so the
port imports nothing of the JAX package).

The production grids ship as external POP binaries; this module synthesizes
stand-ins with the same byte layout, record order, units and staggering as
the files `popgrid` (ice_grid.F90:1000) reads. gx3/gx1: a rotated-pole
mapping puts the grid's north pole over Greenland (75N, 318E), metrics come
from the mapped corner lattice. tx1: a mirror-symmetric tripole stand-in
with spherical metrics and the U fold on the top row. The land mask is the
analytic continents mask at true TLAT/TLON.

The forcing files are written in the containers `io.forcing_files` reads:
NCAR bulk monthly (.npz), JRA55 3-hourly (netCDF3) and the monthly ocean
climatology (.npz). Everything is computed locally with NumPy and SciPy.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from ..core.landmask import continents_mask

RADIUS = 6.37e6          # earth radius (m), reference ice_constants
CM_PER_M = 100.0

# fixture grid dimensions — the production sizes
GRID_DIMS = {"gx3": (100, 116), "gx1": (320, 384), "tx1": (360, 240)}


def fixtures_root() -> str:
    """Fixture cache directory (override with $CICE_TPU_TORCH_FIXTURES)."""
    return os.environ.get(
        "CICE_TPU_TORCH_FIXTURES",
        os.path.join(tempfile.gettempdir(), "cice_tpu_torch_fixtures"))


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------

def _rotated_to_geo(phi_r, lam_r, pole_lat, pole_lon):
    """Map rotated coordinates (radians) to geographic (radians): the
    rotated-frame north pole lands at geographic (pole_lat, pole_lon)."""
    sp, cp = np.sin(pole_lat), np.cos(pole_lat)
    sin_phi = np.sin(phi_r) * sp + np.cos(phi_r) * cp * np.cos(lam_r)
    phi = np.arcsin(np.clip(sin_phi, -1.0, 1.0))
    lam = pole_lon + np.arctan2(
        np.cos(phi_r) * np.sin(lam_r),
        np.sin(phi_r) * cp - np.cos(phi_r) * sp * np.cos(lam_r))
    return phi, np.mod(lam, 2.0 * np.pi)


def _gc_dist(lat1, lon1, lat2, lon2):
    """Great-circle distance (m), haversine form."""
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = (np.sin(0.5 * dlat) ** 2 +
         np.cos(lat1) * np.cos(lat2) * np.sin(0.5 * dlon) ** 2)
    return 2.0 * RADIUS * np.arcsin(np.clip(np.sqrt(a), 0.0, 1.0))


def _corner_metrics(Klat, Klon):
    """HTN/HTE/ANGLE from an augmented corner lattice K[(ny+1), (nx+1)]
    where U[j, i] = K[j+1, i+1] and column 0 is the cyclic wrap of the
    last (POP staggering; ANGLE measured CCW from true east at U)."""
    HTN = _gc_dist(Klat[1:, :-1], Klon[1:, :-1], Klat[1:, 1:], Klon[1:, 1:])
    HTE = _gc_dist(Klat[:-1, 1:], Klon[:-1, 1:], Klat[1:, 1:], Klon[1:, 1:])
    dlam = np.mod(Klon[1:, 1:] - Klon[1:, :-1] + np.pi, 2 * np.pi) - np.pi
    dE = np.cos(Klat[1:, 1:]) * dlam
    dN = Klat[1:, 1:] - Klat[1:, :-1]
    ANGLE = np.arctan2(dN, dE)
    return HTN, HTE, ANGLE


def _tlatlon(ULAT, ULON):
    """T coordinates as the spherical average of the 4 surrounding U
    points (reference Tlatlon)."""
    x = np.cos(ULAT) * np.cos(ULON)
    y = np.cos(ULAT) * np.sin(ULON)
    z = np.sin(ULAT)
    s = lambda f: np.roll(f, 1, axis=1)
    sw = lambda f: f + s(f) + np.roll(f, 1, axis=0) + np.roll(s(f), 1, axis=0)
    tx, ty, tz = 0.25 * sw(x), 0.25 * sw(y), 0.25 * sw(z)
    d = np.maximum(np.sqrt(tx * tx + ty * ty + tz * tz), 1e-30)
    TLAT = np.arcsin(np.clip(tz / d, -1, 1))
    TLON = np.mod(np.arctan2(ty, tx), 2 * np.pi)
    return TLAT, TLON


def _fixture_arrays(Klat, Klon):
    HTN, HTE, ANGLE = _corner_metrics(Klat, Klon)
    ULAT, ULON = Klat[1:, 1:], Klon[1:, 1:]
    TLAT, TLON = _tlatlon(ULAT, ULON)
    d2r = np.pi / 180.0
    kmt = continents_mask(TLAT / d2r, TLON / d2r)
    kmt[0, :] = 0.0
    return dict(ULAT=ULAT, ULON=ULON, HTN=HTN, HTE=HTE, ANGLE=ANGLE,
                TLAT=TLAT, TLON=TLON, kmt=kmt)


def make_displaced_pole_arrays(nx: int, ny: int, pole_lat_deg: float = 75.0,
                               pole_lon_deg: float = 318.0,
                               lat_min: float = -78.0,
                               lat_max: float = 87.0) -> dict:
    """Displaced-pole grid arrays (radians / meters) at (ny, nx)."""
    d2r = np.pi / 180.0
    phi_r = np.linspace(lat_min, lat_max, ny + 1)[:, None] * d2r
    lam_r = (np.arange(nx + 1) * (2.0 * np.pi / nx))[None, :]
    phi_r = np.broadcast_to(phi_r, (ny + 1, nx + 1))
    Klat, Klon = _rotated_to_geo(phi_r, lam_r, pole_lat_deg * d2r,
                                 pole_lon_deg * d2r)
    d = _fixture_arrays(Klat, Klon)
    d["kmt"][-1, :] = 0.0   # closed northern boundary ring (around the pole)
    return d


def make_tripole_arrays(nx: int, ny: int, lat_min: float = -78.0,
                        lat_max: float = 89.0) -> dict:
    """Mirror-symmetric tripole stand-in: spherical metrics, U fold at the
    top row (ug_implementation.rst:279-380 seam semantics)."""
    d2r = np.pi / 180.0
    phi = np.linspace(lat_min, lat_max, ny + 1)[:, None] * d2r
    lam = (np.arange(nx + 1) * (2.0 * np.pi / nx))[None, :]
    Klat = np.broadcast_to(phi, (ny + 1, nx + 1)).copy()
    Klon = np.broadcast_to(lam, (ny + 1, nx + 1)).copy()
    d = _fixture_arrays(Klat, Klon)
    # the top row is the seam, folded by the halo and not closed: make it
    # consistent across the fold (T ghost row ny mirrors row ny-1)
    kmt = d["kmt"]
    kmt[-1] = np.minimum(kmt[-1], kmt[-1][::-1])
    return d


# ---------------------------------------------------------------------------
# POP binary writers (inverse of io.grids.read_pop_grid_binary/read_kmt_binary)
# ---------------------------------------------------------------------------

def write_pop_grid_binary(path: str, d: dict) -> None:
    """Big-endian f64 records ULAT, ULON (radians), HTN, HTE, HUS, HUW (cm),
    ANGLE (radians) — the popgrid layout (ice_grid.F90:1000)."""
    hus = d["HTN"]
    huw = d["HTE"]
    recs = [d["ULAT"], d["ULON"], d["HTN"] * CM_PER_M, d["HTE"] * CM_PER_M,
            hus * CM_PER_M, huw * CM_PER_M, d["ANGLE"]]
    with open(path, "wb") as f:
        for r in recs:
            f.write(np.ascontiguousarray(r, ">f8").tobytes())


def write_kmt_binary(path: str, kmt: np.ndarray) -> None:
    """kmt ocean-level count as big-endian int32 (0 = land)."""
    lev = np.where(kmt > 0.5, 40, 0).astype(">i4")
    with open(path, "wb") as f:
        f.write(np.ascontiguousarray(lev).tobytes())


def ensure_displaced_pole_grid(nx: int, ny: int,
                               root: str | None = None) -> dict:
    """Write (once) the displaced-pole POP grid and kmt binaries for an
    (nx, ny) grid under `root`/grids; returns {"grid": path, "kmt": path}.
    gx1 is (320, 384), gx3 (100, 116)."""
    gdir = os.path.join(root or fixtures_root(), "grids")
    os.makedirs(gdir, exist_ok=True)
    gpath = os.path.join(gdir, f"dp{nx}x{ny}_grid.bin")
    kpath = os.path.join(gdir, f"dp{nx}x{ny}_kmt.bin")
    if not (os.path.exists(gpath) and os.path.exists(kpath)):
        _write_grid_files(gpath, kpath, make_displaced_pole_arrays(nx, ny))
    return {"grid": gpath, "kmt": kpath}


def _write_grid_files(gpath: str, kpath: str, arrs: dict) -> None:
    """The grid and kmt binaries, written under temporary names and then
    renamed: concurrent writers of the same fixture never expose a partial
    file."""
    tag = f".{os.getpid()}.tmp"
    write_pop_grid_binary(gpath + tag, arrs)
    write_kmt_binary(kpath + tag, arrs["kmt"])
    os.replace(gpath + tag, gpath)
    os.replace(kpath + tag, kpath)


# ---------------------------------------------------------------------------
# forcing fixtures
# ---------------------------------------------------------------------------

def _analytic_atm(TLATd, TLONd, doy: float, hour_utc: float = 12.0) -> dict:
    """Smooth seasonal analytic atmosphere evaluated at day-of-year `doy`."""
    latr = np.deg2rad(TLATd)
    lonr = np.deg2rad(TLONd)
    # annual-mean temperature + seasonally reversing anomaly by hemisphere
    tmean = 301.0 - 43.0 * (np.abs(TLATd) / 90.0) ** 2
    amp = 15.0 * (np.abs(TLATd) / 90.0) ** 1.5
    season = -np.cos(2.0 * np.pi * (doy - 15.0) / 365.0)   # NH coldest ~Jan 15
    Tair = tmean + amp * np.sign(TLATd) * season
    # humidity: 80% of saturation (prepare_forcing caps it again)
    Qa = 0.8 * (640380.0 / 1.3) * np.exp(-5107.4 / Tair)
    # zonal circulation bands + drifting synoptic wave
    phase = 2.0 * np.pi * doy / 30.0
    uatm = (6.0 * np.sin(2.0 * latr) ** 2 - 2.0 +
            2.0 * np.cos(3.0 * lonr + phase))
    vatm = 2.0 * np.sin(3.0 * lonr + phase) + np.sin(2.0 * latr)
    # daily-mean downwelling SW from solar declination
    decl = np.deg2rad(-23.44) * np.cos(2.0 * np.pi * (doy + 10.0) / 365.0)
    cosz_noon = np.clip(np.cos(latr - decl), 0.0, 1.0)
    diurnal = max(np.cos(2.0 * np.pi * (hour_utc - 12.0) / 24.0), 0.0)
    fsw = 1365.0 * 0.55 * cosz_noon * (0.4 + 0.6 * diurnal)
    cldf = 0.5 + 0.2 * np.sin(latr) ** 2
    # precipitation (mks kg/m^2/s), ~1 mm/day with storm-track maxima
    fsnow = 1.0e-5 * (0.4 + 0.6 * np.cos(2.0 * latr) ** 2)
    flw = 5.67e-8 * (Tair - 10.0) ** 4 * (0.7 + 0.2 * cldf)
    return dict(Tair=Tair, Qa=Qa, uatm=uatm, vatm=vatm, fsw=fsw, cldf=cldf,
                fsnow=fsnow, flw=flw)


def _atomic_savez(path: str, **arrays) -> None:
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def write_ncar_npz(dirpath: str, TLATd, TLONd, year: int = 2005) -> str:
    """NCAR bulk monthly file: 12 records per field (ncar_dataset layout)."""
    os.makedirs(dirpath, exist_ok=True)
    fields = {k: [] for k in
              ("Tair", "Qa", "uatm", "vatm", "fsw", "cldf", "fsnow")}
    for m in range(12):
        a = _analytic_atm(TLATd, TLONd, doy=(m + 0.5) * 365.0 / 12.0)
        for k in fields:
            fields[k].append(a[k])
    path = os.path.join(dirpath, f"ncar_bulk_{year:04d}.npz")
    _atomic_savez(path, **{k: np.asarray(v, np.float32)
                           for k, v in fields.items()})
    return path


JRA55_VARS = ("airtmp", "spchmd", "wndewd", "wndnwd", "glbrad", "dlwsfc",
              "ttlpcp")


def write_jra55_nc(dirpath: str, TLATd, TLONd, year: int = 2005,
                   nrec: int = 56, rec0: int = 0) -> str:
    """JRA55-format netCDF3: 3-hourly records of airtmp/spchmd/wndewd/
    wndnwd/glbrad/dlwsfc/ttlpcp (jra55_dataset layout). Only `nrec`
    records from `rec0` are materialized: runs must start late enough
    (day_init >= 2 for rec0=0) that no earlier record is read."""
    from scipy.io import netcdf_file
    os.makedirs(dirpath, exist_ok=True)
    ny, nx = np.asarray(TLATd).shape
    path = os.path.join(dirpath, f"JRA55_{year:04d}.nc")
    src = dict(airtmp="Tair", spchmd="Qa", wndewd="uatm", wndnwd="vatm",
               glbrad="fsw", dlwsfc="flw", ttlpcp="fsnow")
    buf = {k: np.empty((nrec, ny, nx), np.float32) for k in JRA55_VARS}
    for r in range(nrec):
        sec = (rec0 + r + 0.5) * 3.0 * 3600.0
        a = _analytic_atm(TLATd, TLONd, 1.0 + sec / 86400.0,
                          hour_utc=(sec / 3600.0) % 24.0)
        for k in JRA55_VARS:
            buf[k][r] = a[src[k]]
    tmp = f"{path}.{os.getpid()}.tmp"
    with netcdf_file(tmp, "w") as f:
        f.createDimension("time", nrec)
        f.createDimension("nj", ny)
        f.createDimension("ni", nx)
        for k in JRA55_VARS:
            f.createVariable(k, "f", ("time", "nj", "ni"))[:] = buf[k]
    os.replace(tmp, path)
    return path


def write_ocean_clim_npz(dirpath: str, TLATd, TLONd) -> str:
    """Monthly ocean climatology (ocean_clim_dataset layout)."""
    os.makedirs(dirpath, exist_ok=True)
    latr = np.deg2rad(np.asarray(TLATd))
    lonr = np.deg2rad(np.asarray(TLONd))
    sst, sss, uocn, vocn, qdp, hmix = [], [], [], [], [], []
    for m in range(12):
        doy = (m + 0.5) * 365.0 / 12.0
        season = -np.cos(2.0 * np.pi * (doy - 15.0) / 365.0)
        t = (28.0 * np.cos(latr) ** 2 - 1.2 +
             1.5 * np.sign(latr) * season * np.abs(np.sin(latr)))
        sst.append(np.maximum(t, -1.8))
        sss.append(34.0 - 2.0 * np.cos(latr) ** 6)
        uocn.append(0.05 * np.sin(2.0 * latr) + 0.02 * np.cos(2 * lonr))
        vocn.append(0.02 * np.sin(2 * lonr))
        qdp.append(np.full_like(t, -2.0))          # W/m^2 deep heat flux
        hmix.append(20.0 + 10.0 * np.cos(latr) ** 2)
    path = os.path.join(dirpath, "ocean_clim.npz")
    _atomic_savez(path, **{k: np.asarray(v, np.float32) for k, v in dict(
        sst=sst, sss=sss, uocn=uocn, vocn=vocn, qdp=qdp,
        hmix=hmix).items()})
    return path


# ---------------------------------------------------------------------------
# the whole baseline set, written once
# ---------------------------------------------------------------------------

def ensure_baseline_fixtures(root: str | None = None, year: int = 2005,
                             verbose: bool = False) -> dict:
    """Create (once) the baseline fixture set under `root` (default
    `fixtures_root()`, i.e. $CICE_TPU_TORCH_FIXTURES):

      {root}/grids/{name}_grid.bin, {name}_kmt.bin     POP binary
      {root}/forcing/{name}/ncar_bulk_YYYY.npz          NCAR bulk monthly
      {root}/forcing/gx1/JRA55_YYYY.nc                  JRA55 3-hourly
      {root}/forcing/{name}/ocean_clim.npz              ocean climatology

    for gx3, gx1 and tx1. Every file is written under a temporary name and
    renamed, and a `.complete` marker comes last, so concurrent callers
    never read a partial set. Returns {name: {"grid", "kmt", "forcing",
    "nx", "ny"}}."""
    root = root or fixtures_root()
    gdir = os.path.join(root, "grids")
    os.makedirs(gdir, exist_ok=True)
    out = {}
    for name, (nx, ny) in GRID_DIMS.items():
        gpath = os.path.join(gdir, f"{name}_grid.bin")
        kpath = os.path.join(gdir, f"{name}_kmt.bin")
        fdir = os.path.join(root, "forcing", name)
        out[name] = {"grid": gpath, "kmt": kpath, "forcing": fdir,
                     "nx": nx, "ny": ny}
        done = os.path.join(fdir, ".complete")
        if os.path.exists(done):
            continue
        if verbose:
            print(f"[fixtures] generating {name} ({nx}x{ny}) ...")
        arrs = (make_tripole_arrays(nx, ny) if name == "tx1"
                else make_displaced_pole_arrays(nx, ny))
        _write_grid_files(gpath, kpath, arrs)
        TLATd = np.rad2deg(arrs["TLAT"])
        TLONd = np.rad2deg(arrs["TLON"])
        write_ncar_npz(fdir, TLATd, TLONd, year)
        write_ocean_clim_npz(fdir, TLATd, TLONd)
        if name == "gx1":
            write_jra55_nc(fdir, TLATd, TLONd, year)
        tmp = f"{done}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write("ok\n")
        os.replace(tmp, done)
    return out


# ---------------------------------------------------------------------------
# the fixture grid in its other file forms: POP netCDF and MOM supergrid
# ---------------------------------------------------------------------------

def _write_nc(path: str, dims: dict, variables: dict) -> None:
    """A netCDF3 file of float64 variables {name: (dim names, array)},
    written under a temporary name and renamed."""
    from scipy.io import netcdf_file
    tmp = f"{path}.{os.getpid()}.tmp"
    with netcdf_file(tmp, "w") as f:
        for name, size in dims.items():
            f.createDimension(name, size)
        for name, (vdims, arr) in variables.items():
            f.createVariable(name, "d", vdims)[:] = arr
    os.replace(tmp, path)


def write_pop_grid_nc(path: str, d: dict, kmt: np.ndarray) -> None:
    """POP netCDF3 grid (the popgrid_nc layout, ice_grid.F90:1077): ulat,
    ulon, angle (radians), htn, hte (cm) and kmt on (nj, ni), the values of
    the POP binary records `d` (`io.grids.read_pop_grid_binary`) unchanged."""
    ny, nx = d["ULAT"].shape
    dims = ("nj", "ni")
    _write_nc(path, {"nj": ny, "ni": nx}, {
        "ulat": (dims, d["ULAT"]), "ulon": (dims, d["ULON"]),
        "htn": (dims, d["HTN"]), "hte": (dims, d["HTE"]),
        "angle": (dims, d["ANGLE"]), "kmt": (dims, kmt)})


def _supernodes(corner: np.ndarray) -> np.ndarray:
    """(2ny+1, 2nx+1) supergrid nodes whose even nodes from (2, 2) on are
    `corner` (ny, nx): the first row and column are extrapolated linearly,
    odd nodes are means of their even neighbours. Grid readers use only
    the even nodes from (2, 2) on."""
    ny, nx = corner.shape
    c = np.empty((ny + 1, nx + 1))
    c[1:, 1:] = corner
    c[0, 1:] = 2.0 * corner[0] - corner[1]
    c[:, 0] = 2.0 * c[:, 1] - c[:, 2]
    s = np.empty((2 * ny + 1, 2 * nx + 1))
    s[::2, ::2] = c
    s[::2, 1::2] = 0.5 * (c[:, :-1] + c[:, 1:])
    s[1::2, :] = 0.5 * (s[:-1:2, :] + s[2::2, :])
    return s


def write_mom_supergrid(path: str, d: dict) -> None:
    """MOM6 supergrid netCDF3 (ice_grid.F90:1702's layout) of POP binary
    records `d`: U corners at the even nodes (degrees), each T-cell edge
    split into two equal halves in metres (dx on the rows of the north
    edges, dy on the columns of the east edges). Halving an edge and
    adding the halves back are exact in binary floating point, so HTN and
    HTE come back bit for bit; the lat/lon and angle pass through degrees
    and come back to a few ulp."""
    ny, nx = d["ULAT"].shape
    rad2deg = 180.0 / np.pi
    half_n = 0.5 * (d["HTN"] * 0.01)           # cm -> m, as popgrid scales
    half_e = 0.5 * (d["HTE"] * 0.01)
    dx = np.empty((2 * ny + 1, 2 * nx))
    dx[2::2, 0::2] = half_n
    dx[2::2, 1::2] = half_n
    dx[0] = dx[2]
    dx[1::2] = 0.5 * (dx[:-1:2] + dx[2::2])
    dy = np.empty((2 * ny, 2 * nx + 1))
    dy[0::2, 2::2] = half_e
    dy[1::2, 2::2] = half_e
    dy[:, 0] = dy[:, 2]
    dy[:, 1::2] = 0.5 * (dy[:, :-1:2] + dy[:, 2::2])
    _write_nc(path, {"nyp": 2 * ny + 1, "nxp": 2 * nx + 1, "ny": 2 * ny,
                     "nx": 2 * nx}, {
        "x": (("nyp", "nxp"), _supernodes(d["ULON"] * rad2deg)),
        "y": (("nyp", "nxp"), _supernodes(d["ULAT"] * rad2deg)),
        "dx": (("nyp", "nx"), dx), "dy": (("ny", "nxp"), dy),
        "angle_dx": (("nyp", "nxp"), _supernodes(d["ANGLE"] * rad2deg))})


def write_ocean_mask_nc(path: str, kmt: np.ndarray) -> None:
    """MOM ocean mask: `mask` (ny, nx), 1 = ocean."""
    ny, nx = kmt.shape
    _write_nc(path, {"ny": ny, "nx": nx},
              {"mask": (("ny", "nx"), (kmt > 0.5).astype(np.float64))})


def write_grid_forms(grid_bin: str, kmt_bin: str, nx: int, ny: int,
                     stem: str) -> dict:
    """The POP binary grid `grid_bin` + `kmt_bin` as a POP netCDF file
    (`<stem>_grid.nc`), a MOM supergrid (`<stem>_mom_supergrid.nc`) and
    its ocean mask (`<stem>_ocean_mask.nc`), each written unless present.
    Returns {"pop_nc", "mom", "mask"} paths."""
    from .grids import read_kmt_binary, read_pop_grid_binary
    out = {"pop_nc": f"{stem}_grid.nc", "mom": f"{stem}_mom_supergrid.nc",
           "mask": f"{stem}_ocean_mask.nc"}
    if all(os.path.exists(p) for p in out.values()):
        return out
    d = read_pop_grid_binary(grid_bin, nx, ny)
    kmt = read_kmt_binary(kmt_bin, nx, ny)
    write_pop_grid_nc(out["pop_nc"], d, kmt)
    write_mom_supergrid(out["mom"], d)
    write_ocean_mask_nc(out["mask"], kmt)
    return out


def ensure_grid_forms(name: str = "gx1", root: str | None = None) -> dict:
    """The baseline fixture grid `name` (written first if missing) in its
    POP netCDF and MOM forms beside its binaries under `root`/grids."""
    root = root or fixtures_root()
    fx = ensure_baseline_fixtures(root)[name]
    stem = os.path.join(root, "grids", name)
    return write_grid_forms(fx["grid"], fx["kmt"], fx["nx"], fx["ny"], stem)


def write_ice_cov_npz(dirpath: str, TLATd, seed: int = 0) -> str:
    """Monthly ice-coverage data for prescribed-ice runs
    (`<dirpath>/ice_cov.npz`, key `ice_cov`, (12, ny, nx) in [0, 1]): a
    seasonal polar cap whose edge moves with the month, its concentration
    drawn from `seed` between 0.6 and 1."""
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(seed)
    lat = np.asarray(TLATd, np.float64)
    cov = np.empty((12,) + lat.shape)
    for m in range(12):
        phase = np.cos(2.0 * np.pi * (m + 0.5 - 2.6) / 12.0)
        cap = (lat > 68.0 - 8.0 * phase) | (lat < -(62.0 + 6.0 * phase))
        cov[m] = np.where(cap, 0.6 + 0.4 * rng.random(lat.shape), 0.0)
    path = os.path.join(dirpath, "ice_cov.npz")
    _atomic_savez(path, ice_cov=cov)
    return path


def ensure_ice_cov(name: str = "gx1", root: str | None = None) -> str:
    """`ice_cov.npz` in the baseline fixture `name`'s forcing directory
    (the `atm_data_dir` of its option set), written once from seed 0."""
    root = root or fixtures_root()
    fx = ensure_baseline_fixtures(root)[name]
    path = os.path.join(fx["forcing"], "ice_cov.npz")
    if not os.path.exists(path):
        from .grids import read_pop_grid_binary
        d = read_pop_grid_binary(fx["grid"], fx["nx"], fx["ny"])
        TLATd = np.rad2deg(_tlatlon(d["ULAT"], d["ULON"])[0])
        write_ice_cov_npz(fx["forcing"], TLATd)
    return path
