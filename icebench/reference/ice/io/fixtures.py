"""Format-true POP grid files: the displaced-pole grid (a copy of the
program's fixture writer, cice_tpu_torch/io/fixtures.py, cut to the
displaced-pole grid and its binary writers).

The production grids ship as external POP binaries; this module synthesizes
stand-ins with the same byte layout, record order, units and staggering as
the files `popgrid` (ice_grid.F90:1000) reads: a rotated-pole mapping puts
the grid's north pole over Greenland (75N, 318E), metrics come from the
mapped corner lattice, and the land mask is the analytic continents mask
at true TLAT/TLON. Everything is computed locally with NumPy.
"""

from __future__ import annotations

import numpy as np

from ..core.landmask import continents_mask

RADIUS = 6.37e6          # earth radius (m), reference ice_constants
CM_PER_M = 100.0


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
