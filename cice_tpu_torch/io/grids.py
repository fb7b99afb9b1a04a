"""Grid-file ingestion: POP binary and netCDF grids, MOM supergrids and
their masks (PyTorch port of cice_tpu/io/grids.py; reference ice_grid.F90
`popgrid`:1000, `popgrid_nc`:1077, `mom_grid`:1702).

Host-side NumPy IO; `core.grid.from_arrays` derives the metrics and puts
the Grid on a device, with the boundary conditions of ew/ns_boundary_type
(tx1: ns_boundary_type='tripole').
"""

from __future__ import annotations

import numpy as np

from ..core.grid import BC, Grid, from_arrays

CM_TO_M = 0.01


def read_pop_grid_binary(path: str, nx: int, ny: int) -> dict:
    """POP binary grid: consecutive big-endian float64 (ny, nx) records
    ULAT, ULON (radians), HTN, HTE, HUS, HUW (cm), ANGLE (radians)."""
    rec = ny * nx
    raw = np.fromfile(path, ">f8")
    names = ["ULAT", "ULON", "HTN", "HTE", "HUS", "HUW", "ANGLE"]
    out = {}
    for k, name in enumerate(names):
        if (k + 1) * rec <= raw.size:
            out[name] = raw[k * rec:(k + 1) * rec].reshape(ny, nx)
    return out


def read_kmt_binary(path: str, nx: int, ny: int) -> np.ndarray:
    """kmt (ocean depth-level count) as big-endian int32 or float64."""
    raw = np.fromfile(path, ">i4")
    if raw.size == ny * nx:
        return raw.reshape(ny, nx).astype(np.float64)
    raw = np.fromfile(path, ">f8")
    return raw[:ny * nx].reshape(ny, nx)


def read_pop_grid_nc(path: str) -> dict:
    """POP netCDF3 grid file (reference popgrid_nc ice_grid.F90:1077):
    ulat/ulon/angle (radians), htn/hte (cm) and, if present, kmt."""
    from scipy.io import netcdf_file
    out = {}
    with netcdf_file(path, "r", mmap=False) as f:
        for key, names in dict(
                ULAT=("ulat", "ULAT"), ULON=("ulon", "ULON"),
                HTN=("htn", "HTN"), HTE=("hte", "HTE"),
                ANGLE=("angle", "ANGLE"), kmt=("kmt", "KMT")).items():
            for n in names:
                if n in f.variables:
                    out[key] = np.array(f.variables[n][:], np.float64)
                    break
    return out


def read_mom_supergrid(path: str) -> dict:
    """MOM6 supergrid netCDF (reference mom_grid, ice_grid.F90:1702).

    The supergrid holds coordinates at DOUBLE resolution: `x`,`y` are
    (2ny+1, 2nx+1) lon/lat in degrees, `dx` (2ny+1, 2nx) and `dy`
    (2ny, 2nx+1) edge lengths in meters, `angle_dx` (2ny+1, 2nx+1) degrees.
    Model U (corner) points are the even supergrid nodes; T-cell edge
    lengths are sums of supergrid half-edges."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        x = np.array(f.variables["x"][:], np.float64)
        y = np.array(f.variables["y"][:], np.float64)
        dx = np.array(f.variables["dx"][:], np.float64)
        dy = np.array(f.variables["dy"][:], np.float64)
        ang = (np.array(f.variables["angle_dx"][:], np.float64)
               if "angle_dx" in f.variables else None)
    ny2, nx2 = dx.shape[0] - 1, dy.shape[1] - 1   # 2*ny, 2*nx
    ny, nx = ny2 // 2, nx2 // 2
    deg2rad = np.pi / 180.0
    out = dict(ULAT=y[2::2, 2::2] * deg2rad,       # (ny, nx) corner lat
               ULON=x[2::2, 2::2] * deg2rad,
               # T-cell north edge (row 2j+2), split at the N point
               HTN=dx[2::2, 0::2] + dx[2::2, 1::2],
               # T-cell east edge (col 2i+2), split at the E point
               HTE=dy[0::2, 2::2] + dy[1::2, 2::2], nx=nx, ny=ny)
    if ang is not None:
        out["ANGLE"] = ang[2::2, 2::2] * deg2rad
    return out


def read_ocean_mask_nc(path: str) -> np.ndarray:
    """MOM ocean_mask.nc / topog-derived wet mask (1 = ocean)."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        for n in ("mask", "wet", "kmt"):
            if n in f.variables:
                return np.array(f.variables[n][:], np.float64)
    raise ValueError(f"no mask/wet/kmt variable in {path}")


def load_grid_files(cfg, dtype=None, device="cuda") -> Grid:
    """Build a Grid from grid_file (+ kmt_file) per grid_format:
    'pop_nc'/'nc' (a kmt variable in the file wins over kmt_file),
    'mom'/'mom_nc' (kmt_file is the ocean mask), else the POP binary
    ('pop_bin'); boundary conditions from
    ew/ns_boundary_type (tripole grids: ns_boundary_type='tripole')."""
    g = cfg.grid
    nx, ny = g.nx_global, g.ny_global
    bc = BC(ew=g.ew_boundary_type, ns=g.ns_boundary_type)
    dtype = dtype if dtype is not None else cfg.np_dtype
    if g.grid_format in ("mom", "mom_nc"):
        d = read_mom_supergrid(g.grid_file)
        kmt = (read_ocean_mask_nc(g.kmt_file) if g.kmt_file
               else np.ones((d["ny"], d["nx"])))
        # MOM edge lengths are in metres already
        return from_arrays(d["ULAT"], d["ULON"], d["HTN"], d["HTE"], kmt,
                           bc, angle=d.get("ANGLE"), dtype=dtype,
                           device=device)
    if g.grid_format in ("pop_nc", "nc"):
        d = read_pop_grid_nc(g.grid_file)
    else:
        d = read_pop_grid_binary(g.grid_file, nx, ny)
    kmt = d.get("kmt")
    if kmt is None:
        kmt = (read_kmt_binary(g.kmt_file, nx, ny) if g.kmt_file
               else np.ones((ny, nx)))
    # HTN/HTE arrive in cm from POP files (the reference scales by cm_to_m)
    return from_arrays(d["ULAT"], d["ULON"], d["HTN"] * CM_TO_M,
                       d["HTE"] * CM_TO_M, kmt, bc, angle=d.get("ANGLE"),
                       dtype=dtype, device=device)
