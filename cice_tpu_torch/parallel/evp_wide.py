"""Wide-halo EVP across ranks: k subcycles per halo exchange (PyTorch port
of cice_tpu/parallel/evp_wide.py).

The reference pays one halo exchange per EVP subcycle (ndte=120..240 per
dynamics step, ice_dyn_evp.F90:908). Here each rank keeps its tile of the
(whole, replicated) inputs plus an H-wide halo ring, runs k subcycles on it
with no message (one B-grid subcycle reads u through the stresses at a net
radius of one ring per side, so H = k rings buy k subcycles; the C grid
needs C_RADIUS rings per subcycle), then refreshes the ring with one
two-stage exchange (`halo_exchange`: rows first, then columns across the
fresh row halos, so corners carry the diagonal neighbour's data). The
interiors are the one-program solve's, bit for bit: the same operations
on the same values.

Boundaries ride the exchange: a rank that receives no message across a
non-cyclic global edge zero-fills that halo (the reference's ghost rule,
ice_boundary.F90:1179-1183; JAX's ppermute zero-fill); cyclic edges add the
wrap messages; the tripole seam is a message between x-mirrored ranks of
the top row that applies the 180-degree fold per plane (`FoldMeta`), then
one more column stage. So every tile runs with open boundaries, and on the
card a tripole grid's tiles go through K1 (kernels/evp.py), which takes no
fold itself (ROADMAP A9).

With the state sharded across the ranks (a tile grid, `core.halo.TileBC`)
each rank's padded inputs are its own tiles, padded and filled by the same
exchange; the solve returns this rank's tiles, and the force tail runs on
the tile through the tile-aware shift. `padded_tiles` pads any stack of
tiles so, for the transport kernels (kernels/remap.py).

What runs the subcycles of a tile: on CUDA tensors (B grid) K1 on the
padded tile, `nsub` subcycles per launch (a solve of f64 CUDA tensors
raises there, as K1 does); on CPU tensors the plain `stress_update` +
`stepu_dense` loop; on the C grid always the plain `c_subcycle_step` loop
(no kernel computes the C-grid EVP). The interiors are gathered on every
rank, and the final force diagnostics run on the whole grid, as the
one-program solve's tail (on the tile, for a sharded state).

EAP on a sharded state (`eap_solve_wide`) runs the same way: its plain
`_subcycle` on each rank's padded tile, k per exchange, the padded state
carrying the structure tensor (a11, a12) beside u, v and the stresses.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from ..core.halo import BC, TileBC
from ..dynamics.common import DynPrep, EvpParams, stepu_dense
from ..dynamics.evp import evp_tail, stress_update

N_CONST = 26
N_STATE = 14

# message tags of the exchange stages
_TAG_Y_UP, _TAG_Y_DOWN, _TAG_X_UP, _TAG_X_DOWN, _TAG_FOLD = range(1, 6)

# the tile's grid: open on every side, the halo ring holds the neighbours
_TILE_BC = BC(ew="open", ns="open")


def _pack_const(grid, prep: DynPrep, strength, DminTarea, uocn, vocn,
                dtype) -> torch.Tensor:
    """Every per-point constant of the subcycle loop as one (N_CONST, ny,
    nx) stack, in K1's plane order (kernels/evp.CONST_PLANES), in the
    caller's dtype."""
    f = lambda x: x.to(dtype)
    planes = [
        f(grid.dxT), f(grid.dyT), f(grid.cxm), f(grid.cxp), f(grid.cym),
        f(grid.cyp), f(grid.dxhy), f(grid.dyhx), f(grid.uarear),
        f(prep.iceTmask), f(prep.iceUmask),
        f(prep.aiU), f(prep.umassdti), f(prep.fm), f(prep.waterx),
        f(prep.watery), f(prep.forcex), f(prep.forcey), f(prep.uvel_init),
        f(prep.vvel_init), f(prep.Cw), f(prep.TbU),
        f(strength), f(DminTarea), f(uocn), f(vocn),
    ]
    assert len(planes) == N_CONST
    return torch.stack(planes)


def _unpack_const(c: torch.Tensor):
    """(tile grid, DynPrep, strength, DminTarea, uocn, vocn) of a padded
    constant stack; the tile grid has open boundaries."""
    h, w = c.shape[-2:]
    g = SimpleNamespace(dxT=c[0], dyT=c[1], cxm=c[2], cxp=c[3], cym=c[4],
                        cyp=c[5], dxhy=c[6], dyhx=c[7], uarear=c[8],
                        bc=_TILE_BC, shape=(h, w))
    prep = DynPrep(iceTmask=c[9] > 0.5, iceUmask=c[10] > 0.5, aiU=c[11],
                   umassdti=c[12], fm=c[13], waterx=c[14], watery=c[15],
                   forcex=c[16], forcey=c[17], uvel_init=c[18],
                   vvel_init=c[19], uvel=c[18], vvel=c[19], Cw=c[20],
                   TbU=c[21])
    return g, prep, c[22], c[23], c[24], c[25]


class FoldMeta:
    """Per-plane tripole fold rules for a (C, ny, nx) packed stack.

    The tripole seam glues the northern edge to itself rotated by 180
    degrees (ug_implementation.rst:279-380): vectors flip both components,
    rank-2 stress components are invariant, corner-indexed stress planes
    swap diagonal partners (NE<->SW, NW<->SE), and the one-sided metric
    combinations swap with sign (cxp<->-cxm, cyp<->-cym; dxhy, dyhx
    negate). `partner[c]` is the source plane, `sign[c]` its factor,
    `pshift[c]` = P - nx of the mirror pivot i -> (P - i) mod nx
    (core/halo.py's fold index rules), `row_corner[c]` the fold-row rule
    (True: ghost ny-1+k <- ny-1-k; False: <- ny-k)."""

    def __init__(self, partner, sign, pshift, row_corner):
        self.partner = np.asarray(partner)
        self.sign = np.asarray(sign, np.float64)
        self.pshift = np.asarray(pshift)
        self.row_corner = np.asarray(row_corner, bool)


def _stage(mesh, z: torch.Tensor, axis: int, H: int, cyclic: bool) -> None:
    """Refresh the two H-wide halos of `z` along `axis` (1: rows, 2:
    columns) from the neighbours along it, in place; a halo across a
    non-cyclic global edge becomes zero."""
    d = (1, 0) if axis == 1 else (0, 1)
    up = mesh.neighbour(*d, y_cyclic=cyclic, x_cyclic=cyclic)
    down = mesh.neighbour(-d[0], -d[1], y_cyclic=cyclic, x_cyclic=cyclic)
    tag_up, tag_down = ((_TAG_Y_UP, _TAG_Y_DOWN) if axis == 1
                        else (_TAG_X_UP, _TAG_X_DOWN))
    n = z.shape[axis]
    sl = lambda a, b: z.narrow(axis, a, b - a)
    lo, hi = sl(0, H), sl(n - H, n)
    sends, recvs = [], []
    if up is not None:
        sends.append((up, sl(n - 2 * H, n - H), tag_up))
    if down is not None:
        sends.append((down, sl(H, 2 * H), tag_down))
        recvs.append((down, lo, tag_up))
    if up is not None:
        recvs.append((up, hi, tag_down))
    mesh.exchange(sends, recvs)
    if down is None:
        lo.zero_()
    if up is None:
        hi.zero_()


def _fold_fill(mesh, z: torch.Tensor, H: int, ly: int,
               meta: FoldMeta) -> None:
    """Overwrite the north halo rows of a top-row tile with the tripole
    fold of its x-mirror's top H+1 interior rows (full padded width, halos
    valid), in place."""
    C, _, W = z.shape
    strip = z[:, ly - 1:H + ly, :]     # global rows ny-1-H .. ny-1
    got = torch.empty_like(strip, memory_format=torch.contiguous_format)
    peer = mesh.mirror()
    mesh.exchange([(peer, strip, _TAG_FOLD)], [(peer, got, _TAG_FOLD)])
    dev = z.device
    got = got[torch.as_tensor(meta.partner, device=dev)] * \
        torch.as_tensor(meta.sign, dtype=z.dtype, device=dev)[:, None, None]
    # column mirror: ghost column p <- strip column (W + pshift - p) mod W;
    # the one wrapped cell of a corner-pivot plane lands in a halo column,
    # which the trailing column stage overwrites with the right data
    p = torch.arange(W, device=dev)
    cols = (W + torch.as_tensor(meta.pshift, device=dev)[:, None] - p) % W
    got = torch.gather(got, 2, cols[:, None, :].expand(C, H + 1, W))
    # rows: strip row r holds global row ny-1-H+r; ghost row k (1..H) takes
    # H-k (corner rule) or H+1-k
    k = torch.arange(1, H + 1, device=dev)
    rows = torch.where(torch.as_tensor(meta.row_corner, device=dev)[:, None],
                       H - k, H + 1 - k)
    z[:, H + ly:, :] = torch.gather(got, 1, rows[:, :, None].expand(C, H, W))


def halo_exchange(mesh, z: torch.Tensor, H: int, *, y_cyclic: bool,
                  x_cyclic: bool, fold_meta: FoldMeta = None,
                  ly: int = 0) -> torch.Tensor:
    """Refresh the H-wide halo ring of a (C, ly+2H, lx+2H) tile from the
    mesh neighbours, in place: the row stage, then the column stage across
    the fresh row halos (corner completion, in place of the reference's
    20-direction messages, ice_blocks.F90:59-88). With `fold_meta` the top
    row's north halo is then the tripole fold of the x-mirror's rows
    (ice_boundary.F90:7910-9052), and one more column stage makes the
    folded rows' corners consistent. Returns z."""
    _stage(mesh, z, 1, H, y_cyclic)
    _stage(mesh, z, 2, H, x_cyclic)
    if fold_meta is not None:
        if mesh.coords[0] == mesh.shape[0] - 1:
            _fold_fill(mesh, z, H, ly, fold_meta)
        _stage(mesh, z, 2, H, x_cyclic)
    return z


def padded_tiles(bc: TileBC, R: int, *tiles):
    """Each (..., ly, lx) tile widened by R rings of the global arrays'
    values around it, (..., ly+2R, lx+2R): zero past a non-cyclic global
    edge, the wrap across a cyclic one. One exchange of all of them
    stacked. No tripole fold: on a tripole grid the VP operator, its one
    caller there, reads through the tile-aware shift instead
    (`dynamics.vp.Stencil`)."""
    flat = [t.reshape((-1,) + tuple(t.shape[-2:])) for t in tiles]
    z = F.pad(torch.cat(flat), (R, R, R, R))
    halo_exchange(bc.mesh, z, R, y_cyclic=bc.y_cyclic, x_cyclic=bc.x_cyclic)
    out, at = [], 0
    for t, f in zip(tiles, flat):
        out.append(z[at:at + f.shape[0]].reshape(
            tuple(t.shape[:-2]) + tuple(z.shape[-2:])))
        at += f.shape[0]
    return out


def _b_fold_metas(ns_kind: str, n_tensors: int = 3):
    """FoldMeta pairs (const, state) for the B-grid packed stacks; the
    state is u, v and `n_tensors` corner-indexed tensor components of 4
    planes each (the stresses; EAP's a11, a12 besides).

    T-centred scalars fold with the centre pivot, U-corner quantities with
    the corner pivot; U vectors flip sign; the one-sided metric
    combinations swap signed partners; corner-indexed planes of rank-2
    tensors (stresses, the structure tensor) swap diagonal corners
    (NE<->SW, NW<->SE) with invariant values."""
    tfold = ns_kind == "tripoleT"
    pc = 0 if tfold else -1       # centre pivot: i -> (nx+pc - i) mod nx
    pu = -1 if tfold else -2      # corner pivot
    rc = True                     # corner fold-row rule (ny-1-k)
    rt = tfold                    # centre fold-row rule (T-fold: ny-1-k)

    # (name, partner offset or None, sign, corner?) per const plane
    CONST = [
        ("dxT", None, 1, 0), ("dyT", None, 1, 0),
        ("cxm", +1, -1, 0), ("cxp", -1, -1, 0),
        ("cym", +1, -1, 0), ("cyp", -1, -1, 0),
        ("dxhy", None, -1, 0), ("dyhx", None, -1, 0),
        ("uarear", None, 1, 1), ("iceTmask", None, 1, 0),
        ("iceUmask", None, 1, 1), ("aiU", None, 1, 1),
        ("umassdti", None, 1, 1), ("fm", None, 1, 1),
        ("waterx", None, -1, 1), ("watery", None, -1, 1),
        ("forcex", None, -1, 1), ("forcey", None, -1, 1),
        ("uvel_init", None, -1, 1), ("vvel_init", None, -1, 1),
        ("Cw", None, 1, 1), ("TbU", None, 1, 1),
        ("strength", None, 1, 0), ("DminTarea", None, 1, 0),
        ("uocn", None, -1, 1), ("vocn", None, -1, 1),
    ]
    partner = [i + (off or 0) for i, (_, off, _s, _c) in enumerate(CONST)]
    sign = [s for (_, _o, s, _c) in CONST]
    corner = [c for (_, _o, _s, c) in CONST]
    cmeta = FoldMeta(partner, sign, [pu if c else pc for c in corner],
                     [rc if c else rt for c in corner])

    # state: u, v, sp1..4, sm1..4, s121..4 (corner order NE, NW, SW, SE)
    swap = {0: 2, 1: 3, 2: 0, 3: 1}   # NE<->SW, NW<->SE
    s_partner = [0, 1] + [2 + 4 * t + swap[i] for t in range(n_tensors)
                          for i in range(4)]
    s_sign = [-1, -1] + [1] * (4 * n_tensors)
    s_corner = [1, 1] + [0] * (4 * n_tensors)
    smeta = FoldMeta(s_partner, s_sign, [pu if c else pc for c in s_corner],
                     [rc if c else rt for c in s_corner])
    return cmeta, smeta


def _chunks(ndte: int, k: int):
    """Subcycle counts between exchanges: k, ..., k, then the remainder."""
    n_full, rem = divmod(ndte, k)
    return [k] * n_full + ([rem] if rem else [])


def _tile_geometry(mesh, shape, radius: int, k_fuse: int, ndte: int):
    py, px = mesh.shape
    ny, nx = shape
    if ny % py or nx % px:
        raise ValueError(f"the wide-halo EVP needs equal tiles: a {ny}x{nx}"
                         f" grid on a {py}x{px} mesh")
    ly, lx = ny // py, nx // px
    # one halo of `radius` rings per fused subcycle, capped below the tile
    # size so that a slab never overruns the neighbour's interior
    k = max(1, min(k_fuse, ndte, (ly - 1) // radius, (lx - 1) // radius))
    return ly, lx, k, radius * k


def _padded_tile(mesh, x: torch.Tensor, H: int,
                 tiled: bool = False) -> torch.Tensor:
    """This rank's tile of `x` (the whole array, or the tile itself if
    `tiled`) with H zero rings for the exchange to fill."""
    return F.pad(x if tiled else mesh.tile(x), (H, H, H, H))


def evp_solve_wide(grid, p: EvpParams, prep: DynPrep, strength, stressp,
                   stressm, stress12, *, uocn, vocn, mesh, k_fuse: int = 8):
    """`dynamics.evp.evp_solve` with k_fuse subcycles per halo exchange on
    `mesh`; returns the same 9-tuple (uvel, vvel, stressp, stressm,
    stress12, strintx, strinty, taubx, tauby) on every rank. mesh=None
    runs the one-program solve `kernels.evp.evp_solve_fused`: K1 on CUDA
    tensors, equal bit for bit to the plain `evp_solve` it runs on CPU
    tensors. On a tile grid the inputs are this rank's tiles, the solve
    runs on the grid's mesh, and it returns this rank's tiles."""
    tiled = isinstance(grid.bc, TileBC)
    if tiled:
        mesh = grid.bc.mesh
    elif mesh is None:
        from ..kernels.evp import evp_solve_fused
        return evp_solve_fused(grid, p, prep, strength, stressp, stressm,
                               stress12, uocn=uocn, vocn=vocn)
    ny, nx = grid.global_shape
    ly, lx, k, H = _tile_geometry(mesh, (ny, nx), 1, k_fuse, p.ndte)
    dtype = prep.uvel.dtype
    DminTarea = p.deltaminEVP * grid.tarea
    m3 = prep.iceTmask[None]
    const = _pack_const(grid, prep, strength, DminTarea, uocn, vocn, dtype)
    state = torch.cat([prep.uvel[None].to(dtype), prep.vvel[None].to(dtype),
                       torch.where(m3, stressp, 0.0).to(dtype),
                       torch.where(m3, stressm, 0.0).to(dtype),
                       torch.where(m3, stress12, 0.0).to(dtype)])
    cmeta = smeta = None
    if grid.bc.tripole:
        cmeta, smeta = _b_fold_metas(grid.bc.ns)
    exch = dict(H=H, y_cyclic=grid.bc.y_cyclic, x_cyclic=grid.bc.x_cyclic,
                ly=ly)

    c = halo_exchange(mesh, _padded_tile(mesh, const, H, tiled),
                      fold_meta=cmeta, **exch)    # the constants: once
    g, prep_l, strength_l, Dmin_l, uocn_l, vocn_l = _unpack_const(c)
    s = _padded_tile(mesh, state, H, tiled)
    on_card = s.is_cuda
    if on_card:
        from ..kernels.evp import evp_solve_cuda
    for nsub in _chunks(p.ndte, k):
        s = halo_exchange(mesh, s, fold_meta=smeta, **exch)
        if on_card:
            tprep = dataclasses.replace(prep_l, uvel=s[0], vvel=s[1])
            s = evp_solve_cuda(g, p._replace(ndte=nsub), tprep, strength_l,
                               s[2:6], s[6:10], s[10:14], uocn=uocn_l,
                               vocn=vocn_l, DminTarea=Dmin_l)[:N_STATE]
            continue
        u, v, sp, sm, s12 = s[0], s[1], s[2:6], s[6:10], s[10:14]
        for _ in range(nsub):
            sp, sm, s12, strintx, strinty = stress_update(
                g, p, strength_l, Dmin_l, u, v, sp, sm, s12,
                prep_l.iceTmask)
            u, v, _, _ = stepu_dense(u, v, strintx, strinty, prep_l, p,
                                     uocn_l, vocn_l)
        s = torch.cat([u[None], v[None], sp, sm, s12])
    out = s[:, H:H + ly, H:H + lx]
    if not tiled:
        out = mesh.all_gather_tiles(out, ny, nx)
    u, v, sp, sm, s12 = out[0], out[1], out[2:6], out[6:10], out[10:14]
    # the force diagnostics on the grid, as evp_solve's tail: the seam
    # row's strint is then the one-program solve's for every boundary
    strintx, strinty, taubx, tauby = evp_tail(grid, p, prep, strength,
                                              DminTarea, u, v, sp, sm, s12)
    return u, v, sp, sm, s12, strintx, strinty, taubx, tauby


def eap_solve_wide(grid, p: EvpParams, prep: DynPrep, strength, stressp,
                   stressm, stress12, *, uocn, vocn, a11, a12,
                   k_fuse: int = 8):
    """`dynamics.eap.eap_solve` on a state sharded across ranks (a tile
    grid): the inputs and outputs are this rank's tiles. k_fuse subcycles
    of the plain `_subcycle` run on the tile padded by k rings between
    halo exchanges, as `evp_solve_wide`; the yield tables are replicated.
    The interiors are the one-process solve's: the same operations on the
    same values. The force and yield-stress diagnostics then run on the
    tile (`eap_finish`, through the tile-aware shift)."""
    from ..dynamics.eap import (EapState, _device_tables, _subcycle,
                                eap_finish)
    mesh = grid.bc.mesh
    ly, lx, k, H = _tile_geometry(mesh, grid.global_shape, 1, k_fuse,
                                  p.ndte)
    dtype = prep.uvel.dtype
    m3 = prep.iceTmask[None]
    const = _pack_const(grid, prep, strength, p.deltaminEVP * grid.tarea,
                        uocn, vocn, dtype)
    state = torch.cat([prep.uvel[None], prep.vvel[None],
                       torch.where(m3, stressp, 0.0),
                       torch.where(m3, stressm, 0.0),
                       torch.where(m3, stress12, 0.0), a11, a12]).to(dtype)
    cmeta = smeta = None
    if grid.bc.tripole:
        cmeta, smeta = _b_fold_metas(grid.bc.ns, n_tensors=5)
    exch = dict(H=H, y_cyclic=grid.bc.y_cyclic, x_cyclic=grid.bc.x_cyclic,
                ly=ly)
    c = halo_exchange(mesh, _padded_tile(mesh, const, H, True),
                      fold_meta=cmeta, **exch)
    g, prep_l, strength_l, _, uocn_l, vocn_l = _unpack_const(c)
    tabs = _device_tables(c.device)
    unpack = lambda z: EapState(z[0], z[1], *(z[2 + 4 * t:6 + 4 * t]
                                               for t in range(5)))
    s = _padded_tile(mesh, state, H, True)
    for nsub in _chunks(p.ndte, k):
        st = unpack(halo_exchange(mesh, s, fold_meta=smeta, **exch))
        for _ in range(nsub):
            st = _subcycle(g, p, prep_l, strength_l, tabs, uocn_l, vocn_l,
                           st)
        s = torch.cat([st.uvel[None], st.vvel[None], st.stressp,
                       st.stressm, st.stress12, st.a11, st.a12])
    return eap_finish(grid, p, prep, strength, tabs,
                      unpack(s[:, H:H + ly, H:H + lx]))


# ---------------------------------------------------------------------------
# C grid. The reference's C-grid loop exchanges five halos per subcycle
# (ice_dyn_evp.F90:938-1101: uvelE, vvelN, T-stress, U-stress and the
# interpolated velocities); the wide-halo trade is larger accordingly.
# ---------------------------------------------------------------------------

# rings one C-grid subcycle reads: velocity averages (1) -> U strain rates
# (1) -> T shear average (1) -> U viscosity average (1) -> stress
# divergence (1) + transverse momentum average (1)
C_RADIUS = 6

_C_GRID_PLANES = ("dxT", "dyT", "dxU", "dyU", "dxE", "dyE", "dxN", "dyN",
                  "tarea", "uarea", "earea", "narea",
                  "hm", "uvm", "npm", "epm")


def evp_c_solve_wide(grid, p: EvpParams, prep, strength, stresspT, stressmT,
                     stress12U, *, mesh, k_fuse: int = 4):
    """`dynamics.evp_c.evp_c_solve` with k_fuse subcycles per halo exchange
    on `mesh`; returns (final CEvpState, uvelU, vvelU) on every rank. A
    tripole grid or mesh=None runs `evp_c_solve`. On a tile grid the
    inputs and outputs are this rank's tiles (the grid's mesh)."""
    from ..core.grid import grid_average_X2Y
    from ..dynamics.evp_c import (CEvpState, CPrep, _tarea_ring,
                                  _uarea_ring, c_subcycle_step, evp_c_solve)

    tiled = isinstance(grid.bc, TileBC)
    if tiled:
        mesh = grid.bc.mesh
    if grid.bc.tripole or mesh is None:
        return evp_c_solve(grid, p, prep, strength, stresspT, stressmT,
                           stress12U)
    ny, nx = grid.global_shape
    ly, lx, k, H = _tile_geometry(mesh, (ny, nx), C_RADIUS, k_fuse, p.ndte)
    dtype = prep.uvelE_init.dtype
    f = lambda x: x.to(dtype)
    # the trailing indicator plane is one on the global domain: after the
    # exchange the halo cells past a non-cyclic edge hold its zero fill,
    # and the state is pinned to zero there each subcycle (the C-grid
    # update, unlike the masked B-grid one, would evolve them)
    const = torch.stack(
        [f(getattr(grid, nm)) for nm in _C_GRID_PLANES] +
        [f(x) for x in prep] +
        [f(strength), f(p.deltaminEVP * grid.tarea),
         torch.ones(grid.shape, dtype=dtype, device=strength.device)])
    state = torch.stack([f(prep.uvelE_init), f(prep.vvelN_init),
                         f(torch.where(prep.iceTmask, stresspT, 0.0)),
                         f(torch.where(prep.iceTmask, stressmT, 0.0)),
                         f(stress12U)])
    exch = dict(H=H, y_cyclic=grid.bc.y_cyclic, x_cyclic=grid.bc.x_cyclic)
    ng = len(_C_GRID_PLANES)

    c = halo_exchange(mesh, _padded_tile(mesh, const, H, tiled), **exch)
    g = SimpleNamespace(bc=_TILE_BC, **{nm: c[i] for i, nm in
                                        enumerate(_C_GRID_PLANES)})
    planes = list(c[ng:ng + len(prep)])
    for i, fld in enumerate(CPrep._fields):
        if fld.startswith("ice"):          # the masks ride as floats
            planes[i] = planes[i] > 0.5
    prep_l = CPrep(*planes)
    strength_l, Dmin_l, ind = c[-3], c[-2], c[-1]
    rings = (_uarea_ring(g), _tarea_ring(g))

    s = _padded_tile(mesh, state, H, tiled)
    for nsub in _chunks(p.ndte, k):
        s = halo_exchange(mesh, s, **exch)
        st = CEvpState(*s)
        for _ in range(nsub):
            st = c_subcycle_step(g, p, prep_l, strength_l, Dmin_l, st,
                                 rings)
            # where, not a product: a NaN made in the dead ghost ring must
            # not survive (NaN * 0 = NaN)
            st = CEvpState(*(torch.where(ind > 0, x, 0.0) for x in st))
        s = torch.stack(list(st))
    out = s[:, H:H + ly, H:H + lx]
    if not tiled:
        out = mesh.all_gather_tiles(out, ny, nx)
    final = CEvpState(*out)
    uvelU = grid_average_X2Y("S", final.uvelE, "E", "U", grid)
    vvelU = grid_average_X2Y("S", final.vvelN, "N", "U", grid)
    return final, uvelU, vvelU
