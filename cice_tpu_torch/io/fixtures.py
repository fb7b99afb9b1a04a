"""Format-true POP grid fixtures (the gx grid and kmt part of
cice_tpu/io/fixtures.py, copied so the port imports nothing of the JAX
package).

The production gx3/gx1 displaced-pole grids ship as external POP binaries;
this module synthesizes stand-ins with the same byte layout, record order,
units and staggering as the files `popgrid` (ice_grid.F90:1000) reads: a
rotated-pole mapping puts the grid's north pole over Greenland (75N, 318E),
metrics come from the mapped corner lattice, and the land mask is the
analytic continents mask at true TLAT/TLON. The forcing-file writers are not
ported yet (ROADMAP: forcing files, coupling and I/O).
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
    HTN, HTE, ANGLE = _corner_metrics(Klat, Klon)
    ULAT, ULON = Klat[1:, 1:], Klon[1:, 1:]
    TLAT, TLON = _tlatlon(ULAT, ULON)
    kmt = continents_mask(TLAT / d2r, TLON / d2r)
    kmt[0, :] = 0.0
    kmt[-1, :] = 0.0        # closed northern boundary ring (around the pole)
    return dict(ULAT=ULAT, ULON=ULON, HTN=HTN, HTE=HTE, ANGLE=ANGLE,
                TLAT=TLAT, TLON=TLON, kmt=kmt)


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
        arrs = make_displaced_pole_arrays(nx, ny)
        # write under temporary names, then rename: concurrent writers of
        # the same fixture never expose a partial file
        tag = f".{os.getpid()}.tmp"
        write_pop_grid_binary(gpath + tag, arrs)
        write_kmt_binary(kpath + tag, arrs["kmt"])
        os.replace(gpath + tag, gpath)
        os.replace(kpath + tag, kpath)
    return {"grid": gpath, "kmt": kpath}
