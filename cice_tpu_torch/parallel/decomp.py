"""Decomposition utilities: space-filling curves, block->rank distributions
and automatic rank-grid selection (the port's own copy of
cice_tpu/parallel/decomp.py; pure NumPy, host-side only).

Analogue of the reference's decomposition stack:

- ``ice_spacecurve`` (shared/ice_spacecurve.F90:35,77,588,812 — GenSpaceCurve
  with Hilbert/Peano/Cinco generators, restricted to nblocks factorable as
  2^n*3^m*5^p): a single *generalized* Hilbert generator (`gilbert2d`) that
  produces a unit-step space-filling curve over ANY (w, h) rectangle, plus
  the classic Hilbert special case.
- ``ice_distribution`` (shared/ice_distribution.F90:58-132 — the 8
  block->processor algorithms ``cartesian, rake, roundrobin, spiralcenter,
  wghtfile, sectrobin, sectcart, spacecurve`` with per-block work weights):
  `create_distribution` implements the same algorithm names over an
  abstract (nby, nbx) block grid, and `distribution_stats` the work
  statistics the reference prints (`ice_distributionGet`).
- ``cice_decomp.csh`` (configuration/scripts/cice_decomp.csh — auto
  block-size/decomposition defaults per grid and pe count): `auto_decomp`
  picks a rank grid for a global grid; `parallel.mesh.Mesh` takes it with
  `grid_shape=`, and `spacecurve_device_order` its rank order with
  `curve_order=True`.

The rank grid tiles the global arrays uniformly, so the load-balancing
distributions serve analysis, not correctness.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "gilbert2d", "hilbert2d", "spacecurve",
    "create_distribution", "distribution_stats",
    "work_per_block", "auto_decomp", "spacecurve_device_order",
]


# ---------------------------------------------------------------------------
# space-filling curves
# ---------------------------------------------------------------------------

def gilbert2d(w: int, h: int) -> np.ndarray:
    """Generalized Hilbert curve over an arbitrary w x h rectangle.

    Returns an (w*h, 2) int array of (x, y) coordinates such that consecutive
    points are 4-neighbors and every cell appears exactly once. Replaces the
    reference's Hilbert/Peano/Cinco trio (ice_spacecurve.F90:77,588,812) and
    lifts its 2^n*3^m*5^p factorability restriction
    (ug_implementation.rst:793-800).

    Parity caveat: when the longer dimension is odd and the shorter even, a
    corner-to-corner edge-connected Hamiltonian path does not exist (bipartite
    parity), so the curve contains exactly one diagonal step — locality is
    unaffected for distribution purposes. Sizes satisfying the reference's
    2/3/5-factorability are never in this case.
    """
    out = []

    def sgn(v):
        return (v > 0) - (v < 0)

    def gen(x, y, ax, ay, bx, by):
        wseg = abs(ax + ay)
        hseg = abs(bx + by)
        dax, day = sgn(ax), sgn(ay)   # unit major direction
        dbx, dby = sgn(bx), sgn(by)   # unit orthogonal direction

        if hseg == 1:
            for _ in range(wseg):
                out.append((x, y))
                x, y = x + dax, y + day
            return
        if wseg == 1:
            for _ in range(hseg):
                out.append((x, y))
                x, y = x + dbx, y + dby
            return

        ax2, ay2 = ax // 2, ay // 2
        bx2, by2 = bx // 2, by // 2
        w2 = abs(ax2 + ay2)
        h2 = abs(bx2 + by2)

        if 2 * wseg > 3 * hseg:
            if (w2 % 2) and (wseg > 2):
                ax2, ay2 = ax2 + dax, ay2 + day
            gen(x, y, ax2, ay2, bx, by)
            gen(x + ax2, y + ay2, ax - ax2, ay - ay2, bx, by)
        else:
            if (h2 % 2) and (hseg > 2):
                bx2, by2 = bx2 + dbx, by2 + dby
            gen(x, y, bx2, by2, ax2, ay2)
            gen(x + bx2, y + by2, ax, ay, bx - bx2, by - by2)
            gen(x + (ax - dax) + (bx2 - dbx), y + (ay - day) + (by2 - dby),
                -bx2, -by2, -(ax - ax2), -(ay - ay2))

    if w >= h:
        gen(0, 0, w, 0, 0, h)
    else:
        gen(0, 0, 0, h, w, 0)
    return np.asarray(out, dtype=np.int64)


def hilbert2d(order: int) -> np.ndarray:
    """Classic Hilbert curve on a 2^order square (ice_spacecurve.F90:812)."""
    n = 1 << order
    return gilbert2d(n, n)


def spacecurve(nbx: int, nby: int) -> np.ndarray:
    """Curve *rank* per block: rank[j, i] = position of block (j,i) along the
    curve (GenSpaceCurve analogue, ice_spacecurve.F90:35)."""
    pts = gilbert2d(nbx, nby)
    rank = np.empty((nby, nbx), dtype=np.int64)
    rank[pts[:, 1], pts[:, 0]] = np.arange(len(pts))
    return rank


# ---------------------------------------------------------------------------
# per-block work estimates (ice_distribution work_per_block; distribution_wght)
# ---------------------------------------------------------------------------

def work_per_block(nbx: int, nby: int,
                   kind: str = "block",
                   lat_t: Optional[np.ndarray] = None,
                   kmt: Optional[np.ndarray] = None,
                   wght: Optional[np.ndarray] = None) -> np.ndarray:
    """(nby, nbx) work weights: 'block' uniform, 'latitude' |lat|-weighted
    ice probability, 'file' explicit weights (distribution_wght namelist,
    shared/ice_distribution.F90 create_local_block_ids work estimates)."""
    if kind == "block":
        w = np.ones((nby, nbx), dtype=np.float64)
    elif kind == "latitude":
        if lat_t is None:
            raise ValueError("latitude weighting needs lat_t (ny, nx)")
        w = _blockify(np.abs(np.sin(np.deg2rad(lat_t))), nbx, nby)
    elif kind == "file":
        if wght is None:
            raise ValueError("file weighting needs wght")
        w = np.asarray(wght, dtype=np.float64)
        if w.shape != (nby, nbx):
            w = _blockify(w, nbx, nby)
    else:
        raise ValueError(f"unknown work weighting '{kind}'")
    if kmt is not None:   # land-block elimination analogue: zero-work blocks
        ocean = _blockify((np.asarray(kmt) > 0).astype(np.float64), nbx, nby)
        w = np.where(ocean > 0, np.maximum(w, 1e-12), 0.0)
    return w


def _blockify(field: np.ndarray, nbx: int, nby: int) -> np.ndarray:
    """Average a (ny, nx) field over an (nby, nbx) block grid."""
    ny, nx = field.shape
    je = np.linspace(0, ny, nby + 1).astype(int)
    ie = np.linspace(0, nx, nbx + 1).astype(int)
    out = np.empty((nby, nbx), dtype=np.float64)
    for j in range(nby):
        for i in range(nbx):
            sl = field[je[j]:je[j + 1], ie[i]:ie[i + 1]]
            out[j, i] = float(sl.mean()) if sl.size else 0.0
    return out


# ---------------------------------------------------------------------------
# distributions (ice_distribution.F90 create_distrb_*)
# ---------------------------------------------------------------------------

_METHODS = ("cartesian", "roundrobin", "sectcart", "sectrobin",
            "spiralcenter", "rake", "spacecurve", "wghtfile")


def create_distribution(nbx: int, nby: int, nprocs: int,
                        method: str = "cartesian",
                        work: Optional[np.ndarray] = None) -> np.ndarray:
    """Map an (nby, nbx) block grid onto `nprocs` processors.

    Returns an (nby, nbx) int array of processor ids in [0, nprocs). Blocks
    with work == 0 get id -1 (land-block elimination,
    infrastructure/ice_domain.F90:457-458). Algorithm names follow
    shared/ice_distribution.F90:93-121.
    """
    if method not in _METHODS:
        raise ValueError(f"unknown distribution '{method}' (one of {_METHODS})")
    if work is None:
        work = np.ones((nby, nbx), dtype=np.float64)
    work = np.asarray(work, dtype=np.float64)
    active = work > 0

    if method == "cartesian":
        py, px = _factor_mesh(nprocs, nbx, nby)
        jmap = np.minimum((np.arange(nby) * py) // max(nby, 1), py - 1)
        imap = np.minimum((np.arange(nbx) * px) // max(nbx, 1), px - 1)
        dist = jmap[:, None] * px + imap[None, :]
    elif method == "roundrobin":
        dist = _assign_order(_raster_order(nbx, nby), active, nprocs,
                             contiguous=False)
    elif method == "sectcart":
        # split x into nprocs-balanced vertical sections (create_distrb_sectcart)
        dist = _sections_x(nbx, nby, nprocs)
    elif method == "sectrobin":
        # round-robin within x-sections: serpentine raster then modulo
        order = _serpentine_order(nbx, nby)
        dist = _assign_order(order, active, nprocs, contiguous=False)
    elif method == "spiralcenter":
        dist = _assign_order(_spiral_order(nbx, nby), active, nprocs,
                             contiguous=True, work=work)
    elif method == "spacecurve":
        pts = gilbert2d(nbx, nby)
        order = pts[:, 1] * nbx + pts[:, 0]
        dist = _assign_order(order, active, nprocs, contiguous=True, work=work)
    elif method in ("rake", "wghtfile"):
        # work-greedy balancing over the serpentine order (rake: iterative
        # work stealing from overloaded neighbors ~ greedy prefix split;
        # wghtfile: same but weights came from a file)
        order = _serpentine_order(nbx, nby)
        dist = _assign_order(order, active, nprocs, contiguous=True, work=work)

    dist = np.where(active, dist, -1)
    return dist.astype(np.int64)


def _raster_order(nbx, nby):
    return np.arange(nbx * nby)


def _serpentine_order(nbx, nby):
    idx = np.arange(nbx * nby).reshape(nby, nbx)
    idx[1::2] = idx[1::2, ::-1]
    return idx.ravel()


def _spiral_order(nbx, nby):
    """Block indices ordered by an outward spiral from the grid center."""
    cj, ci = (nby - 1) / 2.0, (nbx - 1) / 2.0
    jj, ii = np.mgrid[0:nby, 0:nbx]
    r = np.hypot(jj - cj, ii - ci)
    theta = np.arctan2(jj - cj, ii - ci)
    keys = np.lexsort((theta.ravel(), np.round(r.ravel() * 2) / 2))
    return (jj.ravel() * nbx + ii.ravel())[keys]


def _assign_order(order: np.ndarray, active: np.ndarray, nprocs: int,
                  contiguous: bool, work: Optional[np.ndarray] = None):
    """Assign blocks (in `order`) to procs: modulo (contiguous=False) or
    work-balanced contiguous segments along the order."""
    nby, nbx = active.shape
    flat_active = active.ravel()
    dist = np.zeros(nbx * nby, dtype=np.int64)
    act_order = order[flat_active[order]]
    n_act = len(act_order)
    if n_act == 0:
        return dist.reshape(nby, nbx)
    if not contiguous:
        dist[act_order] = np.arange(n_act) % nprocs
    else:
        w = (np.ones(nbx * nby) if work is None else work.ravel())[act_order]
        cum = np.cumsum(w)
        total = cum[-1]
        # greedy prefix split into nprocs near-equal-work segments
        dist[act_order] = np.minimum(
            (cum - w / 2) / total * nprocs, nprocs - 1).astype(np.int64)
    return dist.reshape(nby, nbx)


def _sections_x(nbx, nby, nprocs):
    imap = np.minimum((np.arange(nbx) * nprocs) // max(nbx, 1), nprocs - 1)
    return np.broadcast_to(imap[None, :], (nby, nbx)).copy()


def distribution_stats(dist: np.ndarray, work: Optional[np.ndarray] = None):
    """Work min/max/mean per processor + imbalance (ice_distributionGet
    analogue, shared/ice_distribution.F90:385-543)."""
    if work is None:
        work = np.ones_like(dist, dtype=np.float64)
    nprocs = int(dist.max()) + 1
    per = np.zeros(nprocs)
    for p in range(nprocs):
        per[p] = work[dist == p].sum()
    mean = per.mean() if nprocs else 0.0
    return {
        "nprocs": nprocs,
        "work_min": float(per.min()),
        "work_max": float(per.max()),
        "work_mean": float(mean),
        "imbalance": float(per.max() / mean - 1.0) if mean > 0 else 0.0,
        "active_blocks": int((dist >= 0).sum()),
        "eliminated_blocks": int((dist < 0).sum()),
    }


# ---------------------------------------------------------------------------
# auto decomposition (cice_decomp.csh analogue)
# ---------------------------------------------------------------------------

def _factor_mesh(n: int, nx: int, ny: int) -> Tuple[int, int]:
    """Factor n into (py, px): tiles twice as wide as tall, x widths near a
    multiple of 128 (the JAX package's cost, kept so that both packages
    pick the same rank grid)."""
    best, best_cost = (1, n), math.inf
    for py in range(1, n + 1):
        if n % py:
            continue
        px = n // py
        if py > ny or px > nx:
            continue
        ty, tx = ny / py, nx / px
        # cost: distance of x-tile from a lane multiple + aspect penalty
        lane_pen = (128 - (tx % 128)) % 128 / 128.0
        aspect = abs(math.log(max(ty, 1) / max(tx / 2, 1)))
        cost = aspect + 0.25 * lane_pen
        if cost < best_cost:
            best, best_cost = (py, px), cost
    return best


def auto_decomp(nx_global: int, ny_global: int, n_devices: int
                ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Pick ((py, px) mesh shape, (tile_y, tile_x)) for a global grid —
    the cice_decomp.csh analogue (`_factor_mesh`'s cost)."""
    py, px = _factor_mesh(n_devices, nx_global, ny_global)
    ty = -(-ny_global // py)
    tx = -(-nx_global // px)
    return (py, px), (ty, tx)


def spacecurve_device_order(py: int, px: int) -> np.ndarray:
    """Order the (py, px) rank grid along a generalized-Hilbert curve: a
    locality-preserving rank assignment, so that neighbouring tiles go to
    ranks that are neighbours on the curve (ice_spacecurve's use here)."""
    pts = gilbert2d(px, py)
    return pts[:, 1] * px + pts[:, 0]
