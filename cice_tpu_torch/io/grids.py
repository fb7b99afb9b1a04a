"""Grid-file ingestion: POP binary grids + kmt masks (PyTorch port of the
`pop_bin` path of cice_tpu/io/grids.py; reference popgrid ice_grid.F90:1000).

Host-side NumPy IO; `core.grid.from_arrays` derives the metrics and puts
the Grid on a device, with the boundary conditions of ew/ns_boundary_type
(tx1: ns_boundary_type='tripole'). netCDF and MOM grids are not ported yet
(ROADMAP: forcing files, coupling and I/O).
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


def load_grid_files(cfg, dtype=None, device="cuda") -> Grid:
    """Build a Grid from grid_file (+ kmt_file) for grid_format='pop_bin'."""
    g = cfg.grid
    if g.grid_format not in ("pop_bin",):
        raise NotImplementedError(
            f"grid_format={g.grid_format!r} is not ported yet (ROADMAP: "
            "forcing files, coupling and I/O); use 'pop_bin'")
    nx, ny = g.nx_global, g.ny_global
    bc = BC(ew=g.ew_boundary_type, ns=g.ns_boundary_type)
    d = read_pop_grid_binary(g.grid_file, nx, ny)
    if not g.kmt_file:
        kmt = np.ones((ny, nx))
    else:
        kmt = read_kmt_binary(g.kmt_file, nx, ny)
    htn = d["HTN"] * CM_TO_M
    hte = d["HTE"] * CM_TO_M
    return from_arrays(d["ULAT"], d["ULON"], htn, hte, kmt, bc,
                       angle=d.get("ANGLE"),
                       dtype=dtype if dtype is not None else cfg.np_dtype,
                       device=device)
