"""Exact incremental remapping — Green's-theorem dense formulation
(PyTorch port of cice_tpu/dynamics/remap_exact.py; reference
ice_transport_remap.F90 construct_fields:1009, limited_gradient:1295,
departure_points:1449, transport_integrals:3188, update_fields:3480).

Each edge's swept pentagon CL->CR->DR->DM->DL (edge-local scaled
coordinates) is integrated per candidate donor cell (two rows x three
columns) by Green's theorem with the 1-form -G(x,y) dx: only the pentagon's
own segments, clamped to the candidate region, contribute, and 3-point
Gauss-Legendre in the segment parameter is exact for the cubic integrands.

The plain path `construct_fields -> remap_fluxes -> update_fields` is the
plain PyTorch version of the fused CUDA transport kernel
(kernels/remap.py), which computes reconstruction, fluxes and update in one
pass; only `edge_moments` runs outside it. On C and CD grids the
trajectories start from means of the face velocities and the edge moments
carry the Bentsen edge areas (uvelE * HTE * dt, vvelN * HTN * dt); the
kernels take those moments as they are.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import constants as cst
from ..constants import (FIELD_LOC_CENTER, FIELD_LOC_NECORNER,
                         FIELD_TYPE_SCALAR, FIELD_TYPE_VECTOR)
from ..core.grid import Grid
from ..core.halo import shift
from ..model.state import DEP_VICE, DEP_VSNO, State

# monomial order for region moments: x^p y^q
MONO: Tuple[Tuple[int, int], ...] = ((0, 0), (1, 0), (0, 1), (2, 0), (1, 1),
                                     (0, 2), (3, 0), (2, 1), (1, 2), (0, 3))
MIDX = {pq: k for k, pq in enumerate(MONO)}

# 3-point Gauss-Legendre on [-1, 1]
_GL_X = (-math.sqrt(3.0 / 5.0), 0.0, math.sqrt(3.0 / 5.0))
_GL_W = (5.0 / 9.0, 8.0 / 9.0, 5.0 / 9.0)

# candidate donor cells (row, col): row 'T' = the y>0 half-plane, 'B' =
# y<0; col -1/0/+1 the x column relative to the edge
CANDS: Tuple[Tuple[str, int], ...] = (("T", -1), ("T", 0), ("T", 1),
                                      ("B", -1), ("B", 0), ("B", 1))

# region axis order: (sy, col-constraint) with col 'inf' (no x clamp),
# 'm' (x >= -1/2), 'p' (x >= +1/2)
_REGIONS: Tuple[Tuple[float, str], ...] = ((1.0, "inf"), (1.0, "m"),
                                           (1.0, "p"), (-1.0, "inf"),
                                           (-1.0, "m"), (-1.0, "p"))
_LARGE = 1.0e30

# donor offsets (dj, di) per candidate, in CANDS order: N family T row =
# cell north of the edge, B row = the cell itself; E family frame x =
# north: T = east column, B = home column
OFFS_N = ((1, -1), (1, 0), (1, 1), (0, -1), (0, 0), (0, 1))
OFFS_E = ((-1, 1), (0, 1), (1, 1), (-1, 0), (0, 0), (1, 0))


def _translate_matrix(cx: float, cy: float) -> np.ndarray:
    """(10, 10) matrix T with (x-cx)^p (y-cy)^q moments = T @ M."""
    T = np.zeros((len(MONO), len(MONO)))
    for k, (p, q) in enumerate(MONO):
        for r in range(p + 1):
            for s in range(q + 1):
                T[k, MIDX[(r, s)]] += (math.comb(p, r) * math.comb(q, s) *
                                       (-cx) ** (p - r) * (-cy) ** (q - s))
    return T


# per-candidate translation matrices (candidate-local origin at its center)
_T_CAND = np.stack([_translate_matrix(float(col), 0.5 if row == "T" else -0.5)
                    for row, col in CANDS])


def _shs(f, dj, di, bc):
    return shift(f, dj, di, bc=bc, loc=FIELD_LOC_CENTER,
                 ftype=FIELD_TYPE_SCALAR)


# ---------------------------------------------------------------------------
# flat tracer table (reference ice_transport_driver init_transport:76-237)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FlatTracer:
    name: str            # registry name (or 'hi'/'hs')
    layer: int           # layer index within the registry tracer
    ttype: int           # 1, 2 or 3 (reference tracer_type)
    parent: int          # flat index of parent tracer (-1 for type 1)
    has_dependents: bool
    lo: float = 0.0      # physical value range (TracerSpec rails)
    hi: float = float("inf")


def build_flat_table(registry) -> Tuple[FlatTracer, ...]:
    """Flatten the tracer registry into the remap tracer table with
    reference tracer_type / depend semantics, grouped by tracer type (all
    type-1 entries first, then type 2, then type 3; stable within each
    group, hi/hs leading the type-1 block)."""
    entries: List[dict] = [
        dict(name="hi", layer=0, parent=-1, lo=0.0, hi=float("inf")),
        dict(name="hs", layer=0, parent=-1, lo=0.0, hi=float("inf")),
    ]
    first_flat: Dict[str, int] = {"hi": 0, "hs": 1}
    for spec in registry:
        nlay = spec.nlayers if getattr(spec, "nlayers", 0) else 1
        if spec.parent is not None:
            parent = first_flat[spec.parent]
        elif spec.depend == DEP_VICE:
            parent = 0
        elif spec.depend == DEP_VSNO:
            parent = 1
        else:
            parent = -1
        first_flat[spec.name] = len(entries)
        for lay in range(nlay):
            entries.append(dict(name=spec.name, layer=lay, parent=parent,
                                lo=getattr(spec, "lo", 0.0),
                                hi=getattr(spec, "hi", float("inf"))))

    def depth(k: int) -> int:
        d, p = 1, entries[k]["parent"]
        while p >= 0:
            d += 1
            p = entries[p]["parent"]
        return d

    has_dep = [False] * len(entries)
    for e in entries:
        if e["parent"] >= 0:
            has_dep[e["parent"]] = True

    types = [min(depth(k), 3) for k in range(len(entries))]
    perm = sorted(range(len(entries)), key=lambda k: types[k])
    inv = {old: new for new, old in enumerate(perm)}
    return tuple(FlatTracer(entries[o]["name"], entries[o]["layer"],
                            types[o],
                            inv[entries[o]["parent"]]
                            if entries[o]["parent"] >= 0 else -1,
                            has_dep[o],
                            entries[o]["lo"], entries[o]["hi"])
                 for o in perm)


def _table_runs(table) -> List[Tuple[str, int, int]]:
    """Contiguous (name, start, nlayers) runs of the flat table."""
    runs: List[Tuple[str, int, int]] = []
    k = 0
    while k < len(table):
        name = table[k].name
        n = 1
        while k + n < len(table) and table[k + n].name == name:
            n += 1
        runs.append((name, k, n))
        k += n
    return runs


def _spec_nlayers(spec) -> int:
    return spec.nlayers if getattr(spec, "nlayers", 0) else 0


class _TableArrays:
    """Static per-tracer index/type vectors of the flat table (depth <= 3
    dependency chains as parent / grandparent indices; type-grouped blocks
    of sizes K1/K2/K3) plus the lo/hi rails in transport space (qsno rows
    carry the +rhos*Lfresh positivity offset)."""

    def __init__(self, table):
        self.ttype = np.array([ft.ttype for ft in table])
        praw = np.array([ft.parent for ft in table])
        self.has_p = praw >= 0
        self.par = np.maximum(praw, 0)
        graw = np.array([table[p].parent if p >= 0 else -1 for p in praw])
        self.has_g = graw >= 0
        self.gpar = np.maximum(graw, 0)
        self.is1 = self.ttype == 1
        self.is2 = self.ttype == 2
        self.is3 = self.ttype == 3
        self.has_dep = np.array([ft.has_dependents for ft in table])
        self.K1 = int(self.is1.sum())
        self.K2 = int(self.is2.sum())
        self.K3 = int(self.is3.sum())
        assert (np.diff(self.ttype) >= 0).all(), \
            "flat tracer table must be type-grouped (build_flat_table)"
        off = np.array([cst.rhos * cst.Lfresh if ft.name == "qsno" else 0.0
                        for ft in table])
        self.lo = np.array([getattr(ft, "lo", 0.0) for ft in table]) + off
        self.hi = np.array([getattr(ft, "hi", np.inf) for ft in table]) + off


def state_to_tracers(state: State, registry, table):
    """Pack State into (am, trm): am (ncat+1, ny, nx) mean mass (aice0 +
    aicen); trm (ncat, NT, ny, nx) mean tracers (hi, hs, then registry
    tracers; snow enthalpy offset by +rhos*Lfresh so it is positive)."""
    aicen = state.aicen
    am = torch.cat([state.aice0[None], aicen], dim=0)
    w = torch.where(aicen > cst.puny,
                    1.0 / torch.clamp(aicen, min=cst.puny), 0.0)
    blocks = []
    for name, _k0, nlay in _table_runs(table):
        if name == "hi":
            blocks.append((state.vicen * w)[:, None])
        elif name == "hs":
            blocks.append((state.vsnon * w)[:, None])
        else:
            t = state.trcrn[name]
            off = cst.rhos * cst.Lfresh if name == "qsno" else 0.0
            t = t + off
            blocks.append(t if t.ndim == 4 else t[:, None])
        assert blocks[-1].shape[1] == nlay, (name, nlay)
    trm = torch.cat(blocks, dim=1)
    assert trm.shape[1] == len(table)
    return am, trm


def tracers_to_state(am, trm, state: State, registry, tmask, Tf,
                     table) -> State:
    """Unpack back into State (reference tracers_to_state:1015-1115):
    vicen = hi*aicen, vsnon = hs*aicen, snow enthalpy un-offset, vanished
    categories zeroed except Tsfcn -> Tf."""
    aicen = am[1:] * tmask[None]
    alive = aicen > 0.0
    nlayers = {spec.name: _spec_nlayers(spec) for spec in registry}
    vicen = vsnon = None
    tr_new = {}
    for name, k, nrun in _table_runs(table):
        if name == "hi":
            vicen = torch.where(alive, trm[:, k] * aicen, 0.0)
        elif name == "hs":
            vsnon = torch.where(alive, trm[:, k] * aicen, 0.0)
        elif nlayers[name]:
            off = cst.rhos * cst.Lfresh if name == "qsno" else 0.0
            tr_new[name] = torch.where(alive[:, None],
                                       trm[:, k:k + nrun] - off, 0.0)
        else:
            val = torch.where(alive, trm[:, k], 0.0)
            if name == "Tsfcn":
                val = torch.where(alive, val, Tf[None])
            tr_new[name] = val
    return state.replace(aicen=aicen, vicen=vicen, vsnon=vsnon, trcrn=tr_new)


# ---------------------------------------------------------------------------
# reconstruction (reference construct_fields:1009, limited_gradient:1295)
# ---------------------------------------------------------------------------

def limited_gradient(bc, phi, phimask, cnx, cny):
    """Barth-Jespersen-style limited gradient in scaled coordinates about
    the displaced center (cnx, cny); masked neighbors take the home value."""
    pmn = phi
    pmx = phi
    axis_nbrs = {}
    for (dj, di) in ((1, -1), (1, 0), (1, 1), (0, -1), (0, 1),
                     (-1, -1), (-1, 0), (-1, 1)):
        pm = _shs(phimask, dj, di, bc)
        v = pm * _shs(phi, dj, di, bc) + (1.0 - pm) * phi
        if dj == 0 or di == 0:
            axis_nbrs[(dj, di)] = v
        pmn = torch.minimum(pmn, v)
        pmx = torch.maximum(pmx, v)

    gx = (axis_nbrs[(0, 1)] - axis_nbrs[(0, -1)]) * 0.5
    gy = (axis_nbrs[(1, 0)] - axis_nbrs[(-1, 0)]) * 0.5
    pmn = pmn - phi
    pmx = pmx - phi

    # deviations at the 4 cell corners relative to (cnx, cny)
    w1 = (0.5 - cnx) * gx + (0.5 - cny) * gy
    w2 = (0.5 - cnx) * gx - (0.5 + cny) * gy
    w3 = -(0.5 + cnx) * gx - (0.5 + cny) * gy
    w4 = (0.5 - cny) * gy - (0.5 + cnx) * gx
    qmn = torch.minimum(torch.minimum(w1, w2), torch.minimum(w3, w4))
    qmx = torch.maximum(torch.maximum(w1, w2), torch.maximum(w3, w4))

    lim1 = torch.where(qmn.abs() > pmn.abs(),
                       torch.clamp(pmn / torch.where(qmn != 0.0, qmn, 1.0),
                                   min=0.0), 1.0)
    lim2 = torch.where(qmx.abs() > pmx.abs(),
                       torch.clamp(pmx / torch.where(qmx != 0.0, qmx, 1.0),
                                   min=0.0), 1.0)
    lim = torch.minimum(lim1, lim2) * phimask
    return lim * gx, lim * gy


def construct_fields(grid: Grid, am, trm, table, hm):
    """Reconstruct mass and tracer fields (reference construct_fields).

    Returns (mc, mx, my) for the (ncat+1) mass fields and (tc, tx, ty)
    for the (ncat, NT) tracers in scaled cell-local coordinates about the
    geometric center, and the packed [tc|tx|ty] stack."""
    bc = grid.bc
    zeros = torch.zeros_like(am)
    mmask = (am > cst.puny).to(am.dtype)
    mx, my = limited_gradient(bc, am, hm[None] * torch.ones_like(am),
                              zeros, zeros)
    mc = am

    XXAV = 1.0 / 12.0
    minv = torch.where(am > cst.puny, 1.0 / torch.clamp(am, min=cst.puny),
                       0.0)
    mxav = mx * XXAV * minv          # center-of-mass offsets
    myav = my * XXAV * minv

    mm = am[1:]
    mmask_c = mmask[1:]
    ta = _TableArrays(table)
    K1, K2, K3 = ta.K1, ta.K2, ta.K3

    # type 1 (parents: mass centroid offsets)
    tm1 = trm[:, :K1]
    cnx1 = mxav[1:][:, None]
    cny1 = myav[1:][:, None]
    gx1, gy1 = limited_gradient(bc, tm1, mmask_c[:, None], cnx1, cny1)
    tc1 = tm1 - gx1 * cnx1 - gy1 * cny1
    # center of (mass*tracer), used by type-2 children
    w2 = mm[:, None] * gx1 + mx[1:][:, None] * tc1
    w3 = mm[:, None] * gy1 + my[1:][:, None] * tc1
    denom = mm[:, None] * tm1
    dinv = torch.where(denom.abs() > cst.puny,
                       1.0 / torch.where(denom != 0.0, denom, 1.0), 0.0)
    ctx1 = w2 * XXAV * dinv
    cty1 = w3 * XXAV * dinv

    pieces_tc, pieces_tx, pieces_ty = [tc1], [gx1], [gy1]

    # type 2 (children of type-1 tracers), about the parent's centroid
    if K2:
        par2 = torch.as_tensor(ta.par[K1:K1 + K2], device=trm.device)
        tm2 = trm[:, K1:K1 + K2]
        cnx2 = ctx1[:, par2]
        cny2 = cty1[:, par2]
        pmask2 = mmask_c[:, None] * (tm1[:, par2].abs() > cst.puny).to(
            trm.dtype)
        gx2, gy2 = limited_gradient(bc, tm2, pmask2, cnx2, cny2)
        tc2 = tm2 - gx2 * cnx2 - gy2 * cny2
        pieces_tc.append(tc2)
        pieces_tx.append(gx2)
        pieces_ty.append(gy2)

    # type 3: upwind
    if K3:
        tm3 = trm[:, K1 + K2:]
        pieces_tc.append(tm3)
        pieces_tx.append(torch.zeros_like(tm3))
        pieces_ty.append(torch.zeros_like(tm3))

    NT = len(table)
    tstack = torch.cat(pieces_tc + pieces_tx + pieces_ty, dim=1)
    tc = tstack[:, :NT]
    tx = tstack[:, NT:2 * NT]
    ty = tstack[:, 2 * NT:]
    return mc, mx, my, tc, tx, ty, tstack


# ---------------------------------------------------------------------------
# departure points (reference departure_points:1449)
# ---------------------------------------------------------------------------

def departure_points_scaled(grid: Grid, uvel, vvel, dt, l_dp_midpt=False):
    """Scaled departure displacements at U corners + out-of-bounds flag
    (0-d bool tensor, the reference abort condition)."""
    dpx = -dt * uvel * grid.uvm
    dpy = -dt * vvel * grid.uvm
    oob = ((dpx < -grid.HTN) | (dpx > _shs(grid.HTN, 0, 1, grid.bc)) |
           (dpy < -grid.HTE) | (dpy > _shs(grid.HTE, 1, 0, grid.bc)))
    oob = torch.any(oob & (grid.uvm > 0.5))

    if l_dp_midpt:
        # midpoint-corrected trajectories (reference :1544-1617): the
        # bilinear corner-velocity interpolant at the trajectory midpoint
        shv = lambda f, dj, di: shift(f, dj, di, bc=grid.bc,
                                      loc=FIELD_LOC_NECORNER,
                                      ftype=FIELD_TYPE_VECTOR)
        mpx = 0.5 * dpx / grid.dxU
        mpy = 0.5 * dpy / grid.dyU
        ix = torch.where(mpx >= 0.0, 1, 0)
        jy = torch.where(mpy >= 0.0, 1, 0)
        mpxt = mpx - (ix.to(dpx.dtype) - 0.5)
        mpyt = mpy - (jy.to(dpy.dtype) - 0.5)

        def bilin(f):
            vals = {}
            for ddi in (-1, 0, 1):
                for ddj in (-1, 0, 1):
                    vals[(ddj, ddi)] = shv(f, ddj, ddi)

            def at(dj, di):
                out = torch.zeros_like(f)
                for (oj, oi), v in vals.items():
                    m = (jy + dj - 1 == oj) & (ix + di - 1 == oi)
                    out = torch.where(m, v, out)
                return out
            f_sw = at(0, 0)
            f_se = at(0, 1)
            f_nw = at(1, 0)
            f_ne = at(1, 1)
            return (f_sw * (mpxt - 0.5) * (mpyt - 0.5)
                    - f_se * (mpxt + 0.5) * (mpyt - 0.5)
                    + f_ne * (mpxt + 0.5) * (mpyt + 0.5)
                    - f_nw * (mpxt - 0.5) * (mpyt + 0.5))

        ump = bilin(uvel)
        vmp = bilin(vvel)
        keep = (uvel != 0.0) | (vvel != 0.0)
        dpx = torch.where(keep, -dt * ump * grid.uvm, dpx)
        dpy = torch.where(keep, -dt * vmp * grid.uvm, dpy)

    return dpx / grid.dxU, dpy / grid.dyU, oob


# ---------------------------------------------------------------------------
# Green's-theorem region moments
# ---------------------------------------------------------------------------

def _clamp_interval(lo, hi, g0, g1):
    """Clamp parametric interval [lo, hi] to where the linear function
    g(t) = g0 + (g1-g0) t is >= 0 (elementwise, broadcastable)."""
    dg = g1 - g0
    ts = -g0 / torch.where(dg == 0, 1.0, dg)
    lo2 = torch.where(dg > 0, torch.maximum(lo, ts), lo)
    hi2 = torch.where(dg < 0, torch.minimum(hi, ts), hi)
    empty = (dg == 0) & (g0 < 0)
    lo2 = torch.where(empty, 1.0, lo2)
    hi2 = torch.where(empty, 0.0, hi2)
    return lo2, hi2


def pentagon_cell_moments(verts, edgearea=None):
    """Per-candidate-cell moments of the signed pentagon region.

    verts: 5 (x, y) tuples of (ny, nx) tensors in edge-local scaled
    coordinates, ordered CL, CR, DR, DM, DL. With `edgearea` (the scaled
    signed area, positive for transport toward +y: C and CD grids), DM
    moves normal to the edge until the pentagon's signed area matches it
    (the Bentsen edge-flux adjustment, reference locate_triangles); where
    DR and DL share their x there is nothing to move, and the safe
    denominator keeps the unselected quotient finite.

    Returns a (6, 10, ny, nx) tensor of moments in candidate-local
    coordinates, candidate axis ordered as `CANDS`."""
    (xcl, ycl), (xcr, ycr), (xdr, ydr), (xdm, ydm), (xdl, ydl) = verts
    if edgearea is not None:
        pts = [(xcl, ycl), (xcr, ycr), (xdr, ydr), (xdm, ydm), (xdl, ydl)]
        A0 = 0.0                                      # shoelace
        for i in range(len(pts)):
            x0, y0 = pts[i]
            x1, y1 = pts[(i + 1) % len(pts)]
            A0 = A0 + 0.5 * (x0 * y1 - x1 * y0)
        # the CL->CR->DR->DM->DL loop of a positive transport has a
        # negative shoelace area
        dAdy = 0.5 * (xdr - xdl)                      # d(A0)/d(ydm)
        delta = torch.where(dAdy.abs() > cst.puny,
                            (-edgearea - A0) /
                            torch.where(dAdy != 0.0, dAdy, 1.0), 0.0)
        ydm = ydm + delta

    dtype, dev = xcl.dtype, xcl.device
    sy = torch.tensor([r[0] for r in _REGIONS], dtype=dtype,
                      device=dev)[:, None, None]
    col_a = {"inf": -_LARGE, "m": -0.5, "p": 0.5}
    av = torch.tensor([col_a[r[1]] for r in _REGIONS], dtype=dtype,
                      device=dev)[:, None, None]

    # the CL->CR segment lies on y=0, where G vanishes: skipped
    segs = [((xcr, ycr), (xdr, ydr)),
            ((xdr, ydr), (xdm, ydm)), ((xdm, ydm), (xdl, ydl)),
            ((xdl, ydl), (xcl, ycl))]

    acc = [0.0] * len(MONO)                       # per-monomial (R, ny, nx)
    for (x0, y0), (x1, y1) in segs:
        dx = x1 - x0
        dy = y1 - y0
        lo0 = torch.zeros_like(sy * y0)
        lo, hi = _clamp_interval(lo0, lo0 + 1.0, sy * y0, sy * y1)
        lo, hi = _clamp_interval(lo, hi, x0 - av, x1 - av)
        hi = torch.maximum(hi, lo)
        half = 0.5 * (hi - lo)
        mid = 0.5 * (hi + lo)
        for gx, gw in zip(_GL_X, _GL_W):
            t = mid + half * gx
            x = x0 + dx * t
            y = y0 + dy * t
            w = -(gw * half) * dx                 # -dx weight of the 1-form
            xp = [torch.ones_like(x), x, x * x, x * x * x]
            yq = [y, y * y, y * y * y, y * y * y * y]
            for k, (p, q) in enumerate(MONO):
                acc[k] = acc[k] + w * xp[p] * yq[q] * (1.0 / (q + 1.0))
    tot = torch.stack(acc)                        # (10, R, ny, nx)

    # per-candidate column differences, then the translation matrices
    D = torch.stack([tot[:, 0] - tot[:, 1], tot[:, 1] - tot[:, 2],
                     tot[:, 2], tot[:, 3] - tot[:, 4],
                     tot[:, 4] - tot[:, 5], tot[:, 5]])
    T = torch.as_tensor(_T_CAND, dtype=dtype, device=dev)
    return torch.einsum("cab,cb...->ca...", T, D)


def edge_moments(grid: Grid, dxs, dys, edgearea_e=None, edgearea_n=None):
    """(mom_n, mom_e): per-candidate translated pentagon moments for the
    N and E edge families. dxs/dys: scaled departure displacements at U
    points."""
    shu = lambda f, dj, di: shift(f, dj, di, bc=grid.bc,
                                  loc=FIELD_LOC_NECORNER,
                                  ftype=FIELD_TYPE_VECTOR)
    zeros = torch.zeros_like(dxs)
    # N edges: frame x = east, y = north; CL = U(i-1,j), CR = U(i,j)
    dxl = shu(dxs, 0, -1)
    dyl = shu(dys, 0, -1)
    v_cl = (zeros - 0.5, zeros)
    v_cr = (zeros + 0.5, zeros)
    v_dr = (0.5 + dxs, dys)
    v_dl = (-0.5 + dxl, dyl)
    v_dm = (0.5 * (v_dr[0] + v_dl[0]), 0.5 * (v_dr[1] + v_dl[1]))
    ea_n = None if edgearea_n is None else edgearea_n / grid.narea
    mom_n = pentagon_cell_moments([v_cl, v_cr, v_dr, v_dm, v_dl],
                                  edgearea=ea_n)
    # E edges: frame x = north (xi), y = east (eta); CL = U(i,j-1),
    # CR = U(i,j)
    dxb = shu(dxs, -1, 0)
    dyb = shu(dys, -1, 0)
    v_cl = (zeros - 0.5, zeros)
    v_cr = (zeros + 0.5, zeros)
    v_dr = (0.5 + dys, dxs)
    v_dl = (-0.5 + dyb, dxb)
    v_dm = (0.5 * (v_dr[0] + v_dl[0]), 0.5 * (v_dr[1] + v_dl[1]))
    ea_e = None if edgearea_e is None else edgearea_e / grid.earea
    mom_e = pentagon_cell_moments([v_cl, v_cr, v_dr, v_dm, v_dl],
                                  edgearea=ea_e)
    return mom_n, mom_e


# ---------------------------------------------------------------------------
# flux assembly (reference transport_integrals:3188)
# ---------------------------------------------------------------------------

def _chain_product(trm, base, ta: _TableArrays):
    """Old-state chain products base * trcr * trcr[parent] * trcr[gparent]
    per flat tracer (reference state_to_work weight chains)."""
    K1, K2, K3 = ta.K1, ta.K2, ta.K3
    dev = trm.device
    c1 = trm[:, :K1]
    parts = [c1]
    if K2:
        p2 = torch.as_tensor(ta.par[K1:K1 + K2], device=dev)
        c2 = trm[:, K1:K1 + K2] * c1[:, p2]
        parts.append(c2)
    if K3:
        p3 = torch.as_tensor(ta.par[K1 + K2:] - K1, device=dev)
        parts.append(trm[:, K1 + K2:] * c2[:, p3])
    return base[:, None] * torch.cat(parts, dim=1)


def _family_fluxes(grid: Grid, moments, offsets, mc, mx, my, tc, tx, ty,
                   table, areafac, sign):
    """Sum mass and mass*tracer transports over the candidate cells.

    moments: (6, 10, ny, nx) per-candidate moments (CANDS order);
    offsets: per-candidate (dj, di) shift taking edge (j, i) to the donor.
    Returns (mflx (ncat+1, ...), mtflx (ncat, NT, ...)) in physical
    units. Every contribution is linear in the donor fields and, away from
    a tripole fold, the ghost fill is zero, so the moments are back-shifted
    to the donor and the single result forward-shifted to the edge. A fold
    mirrors the donors but not the moments, so there the donor fields are
    shifted directly, the gradients as vectors (their sign flips)."""
    bc = grid.bc
    ta = _TableArrays(table)
    dt_, dev = mc.dtype, mc.device
    t1 = torch.as_tensor(ta.is1, dtype=dt_, device=dev)[:, None, None]
    t2 = torch.as_tensor(ta.is2, dtype=dt_, device=dev)[:, None, None]
    t3 = torch.as_tensor(ta.is3, dtype=dt_, device=dev)[:, None, None]

    if tc is not None:
        par = torch.as_tensor(ta.par, device=dev)
        gpar = torch.as_tensor(ta.gpar, device=dev)
        tcp, txp, typ = tc[:, par], tx[:, par], ty[:, par]
        tcg, txg, tyg = tc[:, gpar], tx[:, gpar], ty[:, gpar]

    direct = bc.tripole
    mflx = 0.0
    mtflx = 0.0
    for c, (dj, di) in enumerate(offsets):
        if direct:
            M = moments[c]
            S_s = lambda a: _shs(a, dj, di, bc)
            S_v = lambda a: shift(a, dj, di, bc=bc, loc=FIELD_LOC_CENTER,
                                  ftype=FIELD_TYPE_VECTOR)
            post = lambda u: u
        else:
            M = _shs(moments[c], -dj, -di, bc)
            S_s = S_v = lambda a: a
            post = lambda u: _shs(u, dj, di, bc)
        mc_c, mx_c, my_c = S_s(mc), S_v(mx), S_v(my)

        def mom(p, q):
            return M[MIDX[(p, q)]]

        msum = mc_c * mom(0, 0) + mx_c * mom(1, 0) + my_c * mom(0, 1)
        mflx = mflx + post(msum)

        if tc is not None:
            tc_c, tx_c, ty_c = S_s(tc), S_v(tx), S_v(ty)
            tcp_c, txp_c, typ_c = S_s(tcp), S_v(txp), S_v(typ)
            tcg_c, txg_c, tyg_c = S_s(tcg), S_v(txg), S_v(tyg)
            mi = mc_c[1:][:, None]
            mxi = mx_c[1:][:, None]
            myi = my_c[1:][:, None]
            mxsum = mi * mom(1, 0) + mxi * mom(2, 0) + myi * mom(1, 1)
            mysum = mi * mom(0, 1) + mxi * mom(1, 1) + myi * mom(0, 2)
            mxxsum = mi * mom(2, 0) + mxi * mom(3, 0) + myi * mom(2, 1)
            mxysum = mi * mom(1, 1) + mxi * mom(2, 1) + myi * mom(1, 2)
            myysum = mi * mom(0, 2) + mxi * mom(1, 2) + myi * mom(0, 3)
            msum_i = msum[1:][:, None]

            def m1(a, b, c_):
                """type-1 first-moment sum of a reconstruction (a, b, c)."""
                return msum_i * a + mxsum * b + mysum * c_

            # stage 1: every tracer as if type 1
            mts1 = m1(tc_c, tx_c, ty_c)
            # stage 2: the (type-1) parent's first/second moment sums
            # contracted with this tracer's reconstruction
            mts1_p = m1(tcp_c, txp_c, typ_c)
            mtx1_p = mxsum * tcp_c + mxxsum * txp_c + mxysum * typ_c
            mty1_p = mysum * tcp_c + mxysum * txp_c + myysum * typ_c
            mts2 = mts1_p * tc_c + mtx1_p * tx_c + mty1_p * ty_c
            # stage 3: type-3 upwind from the (type-2) parent, whose own
            # parent is the grandparent
            mts1_g = m1(tcg_c, txg_c, tyg_c)
            mtx1_g = mxsum * tcg_c + mxxsum * txg_c + mxysum * tyg_c
            mty1_g = mysum * tcg_c + mxysum * txg_c + myysum * tyg_c
            mts2_p = mts1_g * tcp_c + mtx1_g * txp_c + mty1_g * typ_c
            mts3 = mts2_p * tc_c
            mts = t1 * mts1 + t2 * mts2 + t3 * mts3
            mtflx = mtflx + post(mts)

    mflx = sign * mflx * areafac[None]
    if tc is not None:
        mtflx = sign * mtflx * areafac[None, None]
    return mflx, (mtflx if tc is not None else None)


def fluxes_from_moments(grid: Grid, mom_n, mom_e, mc, mx, my, tc, tx, ty,
                        table):
    """(mflxe, mflxn, mtflxe, mtflxn): mass and tracer transports across E
    and N edges (positive = east/north) from the edge moments."""
    mflxn, mtflxn = _family_fluxes(grid, mom_n, OFFS_N, mc, mx, my,
                                   tc, tx, ty, table,
                                   grid.narea * grid.npm, sign=-1.0)
    mflxe, mtflxe = _family_fluxes(grid, mom_e, OFFS_E, mc, mx, my,
                                   tc, tx, ty, table,
                                   grid.earea * grid.epm, sign=-1.0)
    return mflxe, mflxn, mtflxe, mtflxn


def remap_fluxes(grid: Grid, dxs, dys, mc, mx, my, tc, tx, ty, table,
                 edgearea_e=None, edgearea_n=None):
    """Mass/tracer transports across N and E edges (plain path)."""
    mom_n, mom_e = edge_moments(grid, dxs, dys, edgearea_e, edgearea_n)
    return fluxes_from_moments(grid, mom_n, mom_e, mc, mx, my, tc, tx, ty,
                               table)


# ---------------------------------------------------------------------------
# update (reference update_fields:3480)
# ---------------------------------------------------------------------------

def update_pre_floor(grid: Grid, am, trm, mflxe, mflxn, mtflxe, mtflxn,
                     table):
    """Flux-form update: returns (am_pre, trm_new) with am_pre the mass
    BEFORE the negative-mass floor (open-water row included), the form
    the fused kernel emits. Tracers solve the new-value chains against the
    floored mass, with puny floors on every chain denominator and the
    registry lo/hi rails."""
    div = lambda fe, fn: (fe - _shs(fe, 0, -1, grid.bc) + fn -
                          _shs(fn, -1, 0, grid.bc))
    ta = _TableArrays(table)
    K1, K2, K3 = ta.K1, ta.K2, ta.K3
    dev = trm.device

    prods = _chain_product(trm, am[1:], ta)
    am_pre = am - div(mflxe, mflxn) * grid.tarear[None]
    tmask = grid.tmask
    am_new = torch.where(tmask[None], torch.clamp(am_pre, min=0.0), 0.0)

    mm = am_new[1:][:, None]
    mm_pos = mm > cst.puny
    num = prods - div(mtflxe, mtflxn) * grid.tarear[None, None]

    def solve(numb, denom, ok):
        return torch.where(ok, numb / torch.where(denom != 0.0, denom, 1.0),
                           0.0)

    val1 = solve(num[:, :K1], mm, mm_pos)
    parts = [val1]
    if K2:
        tp = val1[:, torch.as_tensor(ta.par[K1:K1 + K2], device=dev)]
        val2 = solve(num[:, K1:K1 + K2], mm * tp,
                     mm_pos & (tp.abs() > cst.puny))
        parts.append(val2)
    if K3:
        tp2 = val2[:, torch.as_tensor(ta.par[K1 + K2:] - K1, device=dev)]
        gp = val1[:, torch.as_tensor(ta.gpar[K1 + K2:], device=dev)]
        val3 = solve(num[:, K1 + K2:], mm * tp2 * gp,
                     mm_pos & (tp2.abs() > cst.puny) & (gp.abs() > cst.puny))
        parts.append(val3)
    trm_new = torch.cat(parts, dim=1)
    lo = torch.as_tensor(ta.lo, dtype=trm.dtype, device=dev)
    hi = torch.as_tensor(ta.hi, dtype=trm.dtype, device=dev)
    trm_new = torch.clamp(trm_new, lo[None, :, None, None],
                          hi[None, :, None, None])
    return am_pre, trm_new


def floor_mass(grid: Grid, am_pre):
    """(am_new, neg, depth): the floored mass, the negative-mass flag
    (some ocean cell below -puny) and the depth of the most negative
    ocean-cell mass before the floor (0 when none is negative)."""
    tmask = grid.tmask[None]
    neg = torch.any((am_pre < -cst.puny) & tmask)
    depth = torch.clamp(-torch.where(tmask, am_pre, 0.0).amin(), min=0.0)
    am_new = torch.where(tmask, torch.clamp(am_pre, min=0.0), 0.0)
    return am_new, neg, depth


def update_fields(grid: Grid, am, trm, mflxe, mflxn, mtflxe, mtflxn, table):
    """Flux-form update of mass and tracers; returns (am, trm, neg_flag)."""
    am_pre, trm_new = update_pre_floor(grid, am, trm, mflxe, mflxn, mtflxe,
                                       mtflxn, table)
    am_new, neg, _ = floor_mass(grid, am_pre)
    return am_new, trm_new, neg


# ---------------------------------------------------------------------------
# checks (reference ice_transport_driver global_conservation:1124,
# local_max_min / quasilocal_max_min / check_monotonicity:1360-1493)
# ---------------------------------------------------------------------------

def global_sums(grid: Grid, am, trm, table):
    """Sum of area and of area*tracer-chain-product over the domain."""
    w = grid.tarea * grid.hm
    asum = (am * w[None]).sum(dim=(-2, -1))
    pr = _chain_product(trm, am[1:], _TableArrays(table))
    prods = (pr * w[None, None]).sum(dim=(-2, -1))
    return asum, prods                          # (ncat+1,), (ncat, NT)


def monotonicity_bounds(grid: Grid, am, trm, table):
    """Local min/max of each tracer over the 3x3 neighborhood (masked),
    widened by one more ring (reference quasilocal_max_min)."""
    bc = grid.bc
    aim = (am[1:] > cst.puny).to(trm.dtype)
    ta = _TableArrays(table)
    dev, dt_ = trm.device, trm.dtype
    p1 = trm[:, torch.as_tensor(ta.par, device=dev)]
    p2 = trm[:, torch.as_tensor(ta.gpar, device=dev)]
    m1 = torch.as_tensor(ta.has_p, dtype=dt_, device=dev)[:, None, None]
    m2 = torch.as_tensor(ta.has_g, dtype=dt_, device=dev)[:, None, None]
    ok1 = m1 * (p1.abs() > cst.puny).to(dt_) + (1.0 - m1)
    ok2 = m2 * (p2.abs() > cst.puny).to(dt_) + (1.0 - m2)
    tmask_t = aim[:, None] * ok1 * ok2

    big = 1e30
    tmn = torch.where(tmask_t > 0.5, trm, big)
    tmx = torch.where(tmask_t > 0.5, trm, -big)
    for _ in range(2):   # 3x3 then one more ring (quasilocal)
        mn, mx = tmn, tmx
        for (dj, di) in ((0, 1), (0, -1), (1, 0), (-1, 0),
                         (1, 1), (1, -1), (-1, 1), (-1, -1)):
            mn = torch.minimum(mn, _shs(tmn, dj, di, bc))
            mx = torch.maximum(mx, _shs(tmx, dj, di, bc))
        tmn, tmx = mn, mx
    tmn = torch.where(tmn > 0.5 * big, 0.0, tmn)
    tmx = torch.where(tmx < -0.5 * big, 0.0, tmx)
    return tmn, tmx


def check_monotonicity(tmin, tmax, am_new, trm_new, table, tol=None):
    """True if any updated tracer escapes its local bounds (masked),
    relative tolerance max(1, |bound|) * tol."""
    if tol is None:
        tol = 1e4 * cst.puny
    alive = am_new[1:] > 1e6 * cst.puny
    w_lo = torch.clamp(tmin.abs(), min=1.0) * tol
    w_hi = torch.clamp(tmax.abs(), min=1.0) * tol
    viol = ((trm_new < tmin - w_lo) | (trm_new > tmax + w_hi)) & \
        alive[:, None]
    return torch.any(viol)


# ---------------------------------------------------------------------------
# top-level driver (reference horizontal_remap:3077 + transport_remap:252)
# ---------------------------------------------------------------------------

def corner_velocities_and_edge_areas(grid: Grid, state: State, grid_ice,
                                     dt):
    """(ucorn, vcorn, edgearea_e, edgearea_n): the velocities that trace
    the corners back, and the Bentsen edge areas (None on the B grid). On
    C and CD grids the corners take means of the prognostic face velocities
    and the edge areas are uvelE * HTE * dt and vvelN * HTN * dt
    (horizontal_remap:629-668)."""
    if grid_ice not in ("C", "CD"):
        return state.uvel, state.vvel, None, None
    shc = lambda f, dj, di: shift(f, dj, di, bc=grid.bc,
                                  loc=FIELD_LOC_CENTER,
                                  ftype=FIELD_TYPE_VECTOR)
    return (0.5 * (state.uvelE + shc(state.uvelE, 1, 0)),
            0.5 * (state.vvelN + shc(state.vvelN, 0, 1)),
            state.uvelE * grid.HTE * dt, state.vvelN * grid.HTN * dt)


def horizontal_remap_exact(grid: Grid, state: State, registry, Tf, dt,
                           grid_ice: str = "B", l_dp_midpt: bool = False,
                           conserv_check: bool = False,
                           monotonicity_check: bool = False,
                           flux_kernel: str = "xla"):
    """Exact incremental remapping of the full ice state.

    flux_kernel: 'xla' runs the plain PyTorch path; 'fused_full' runs the
    one-pass transport (kernels/remap.transport_fused) and 'fused_pallas'
    the flux-only kernel (kernels/remap.tracer_fluxes_fused) between
    `construct_fields` and `update_pre_floor`. On CUDA tensors both launch
    their kernel or raise: a tripole or y-cyclic grid (ROADMAP A9), f64
    state and a failed build or launch raise, and nothing stands in for
    the kernel (the JAX package falls back to its XLA path instead). On
    CPU tensors the wrappers run their plain versions. Returns (new_state,
    diag) with 0-d tensors 'oob', 'neg_mass', 'mono_violation',
    'cons_err_area', 'cons_err_tracer' (relative errors; 0 when checks are
    off) and
    'neg_mass_depth', the most negative ocean-cell mass before the floor,
    negated (the JAX package reports only the flag)."""
    if flux_kernel not in ("xla", "fused_full", "fused_pallas"):
        raise ValueError(f"flux_kernel={flux_kernel!r}: expected 'xla', "
                         "'fused_full' or 'fused_pallas' ('auto' resolves "
                         "in model/step)")
    table = build_flat_table(registry)
    am, trm = state_to_tracers(state, registry, table)

    ucorn, vcorn, edgearea_e, edgearea_n = corner_velocities_and_edge_areas(
        grid, state, grid_ice, dt)
    dxs, dys, oob = departure_points_scaled(grid, ucorn, vcorn, dt,
                                            l_dp_midpt)
    if conserv_check:
        asum0, atsum0 = global_sums(grid, am, trm, table)
    if monotonicity_check:
        tmn, tmx = monotonicity_bounds(grid, am, trm, table)

    if flux_kernel == "fused_full":
        from ..kernels.remap import transport_fused
        mom_n, mom_e = edge_moments(grid, dxs, dys, edgearea_e, edgearea_n)
        am_pre, trm_new = transport_fused(grid, mom_n.contiguous(),
                                          mom_e.contiguous(), am, trm, table)
    else:
        mc, mx, my, tc, tx, ty, tstack = construct_fields(grid, am, trm,
                                                          table, grid.hm)
        if flux_kernel == "fused_pallas":
            from ..kernels.remap import tracer_fluxes_fused
            mom_n, mom_e = edge_moments(grid, dxs, dys, edgearea_e,
                                        edgearea_n)
            mflxe, mflxn, mtflxe, mtflxn = tracer_fluxes_fused(
                grid, mom_n, mom_e, mc, mx, my, tc, tx, ty, table,
                tstack=tstack)
        else:
            mflxe, mflxn, mtflxe, mtflxn = remap_fluxes(
                grid, dxs, dys, mc, mx, my, tc, tx, ty, table, edgearea_e,
                edgearea_n)
        am_pre, trm_new = update_pre_floor(grid, am, trm, mflxe, mflxn,
                                           mtflxe, mtflxn, table)
    am_new, neg, depth = floor_mass(grid, am_pre)

    zero = torch.zeros((), dtype=am.dtype, device=am.device)
    diag = {"oob": oob, "neg_mass": neg, "neg_mass_depth": depth}
    if conserv_check:
        asum1, atsum1 = global_sums(grid, am_new, trm_new, table)
        scale_a = torch.clamp(asum0.abs(), min=1.0)
        floor_t = 1e-6 * torch.clamp(atsum0.abs().max(), min=1.0)
        scale_t = torch.maximum(atsum0.abs(), floor_t)
        diag["cons_err_area"] = ((asum1 - asum0).abs() / scale_a).max()
        diag["cons_err_tracer"] = ((atsum1 - atsum0).abs() / scale_t).max()
    else:
        diag["cons_err_area"] = zero
        diag["cons_err_tracer"] = zero
    if monotonicity_check:
        diag["mono_violation"] = check_monotonicity(tmn, tmx, am_new,
                                                    trm_new, table)
    else:
        diag["mono_violation"] = torch.zeros((), dtype=torch.bool,
                                             device=am.device)

    new_state = tracers_to_state(am_new, trm_new, state, registry,
                                 grid.tmask, Tf, table)
    return new_state, diag
