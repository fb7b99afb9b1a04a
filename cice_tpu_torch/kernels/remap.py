"""Exact-remap transport kernels: wrappers of the CUDA kernels
csrc/transport_fused.cu and csrc/tracer_fluxes.cu.

`transport_fused(grid, mom_n, mom_e, am, trm, table) -> (am_pre, trm_new)`
computes reconstruction, edge fluxes and the flux-divergence update in one
kernel launch; only the edge-moment geometry (`edge_moments`) stays outside.
`am_pre` is the mass before the negative-mass floor (open-water row
included). It replaces cice_tpu/kernels/remap_pallas.py:transport_fused.

`tracer_fluxes_fused(grid, mom_n, mom_e, mc, mx, my, tc, tx, ty, table,
tstack=...) -> (mflxe, mflxn, mtflxe, mtflxn)` computes only the edge
fluxes from the reconstructed fields, between `construct_fields` and
`update_pre_floor`. It replaces
cice_tpu/kernels/remap_pallas.py:tracer_fluxes_fused.

Both kernels walk the tracers in the table's dependency order
(`chain_order`: each parent followed by its children).

On CPU tensors each wrapper runs its plain PyTorch version
(`transport_plain`, `tracer_fluxes_plain`); on CUDA tensors it launches its
kernel or raises. Neither kernel knows a tripole fold or a y-cyclic wrap
(ROADMAP A9), and both are float32: on CUDA tensors such a grid or dtype
raises, and a run that wants the plain transport there names it
(remap_kernel='xla').

On a tile of a sharded grid (`core.halo.TileBC`) each kernel runs as the
one-program kernel would on the whole grid: its inputs are padded by the
rings the kernel reads around a cell (K2_RADIUS, K3_RADIUS) with the
neighbours' values through one halo exchange (zero past a non-cyclic
global edge, the wrap across a cyclic one), the kernel runs on the padded
tile with no wrap of its own, and the outputs are cut back to the tile.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.grid import Grid
from ..core.halo import TileBC
from ..dynamics.remap_exact import (_TableArrays, construct_fields,
                                    fluxes_from_moments, update_pre_floor)
from ._build import check, load

#: times the one-pass transport kernel was launched
launches = 0
#: tracer chunks of its schedule the one-pass kernel walked, summed over
#: its launches (counted on the host from the schedule, no device read)
chunk_launches = 0
#: times the flux-only kernel was launched
flux_launches = 0

# thread-block tiles (x, y) in order of preference: the first whose shared
# memory fits takes it (smaller tiles leave room for more kept values)
TILES = ((32, 8), (32, 4), (32, 2), (32, 1), (16, 1), (8, 1))
MAX_SMEM = 232448          # bytes a block may use on sm_90
#: reconstructions one chunk of the schedule may hold
CHUNK = 16
#: rings around a tile that K2 reads for the tile's cells: a cell's update
#: takes the fluxes of its four edges, whose donors lie one cell away, and
#: each donor's limited reconstruction reads its 3x3 neighbourhood
K2_RADIUS = 2
#: rings K3 reads: a cell's east and north fluxes take the reconstructions
#: of donors one cell away (the update, plain, shifts the fluxes)
K3_RADIUS = 1


def _crop(R: int, *outs):
    return [o[..., R:o.shape[-2] - R, R:o.shape[-1] - R].contiguous()
            for o in outs]


def block_threads(tx: int, ty: int) -> int:
    """Threads of one block: one per edge the (tx, ty) tile owns, ty x
    (tx+1) east edges and (ty+1) x tx north edges, each family padded to
    whole warps (mirrors transport_threads in the CUDA source)."""
    pad = lambda n: (n + 31) // 32 * 32
    return pad(ty * (tx + 1)) + pad((ty + 1) * tx)


class Layout(NamedTuple):
    """Where the parts of a packed schedule lie in its int array, and the
    sizes the kernel's shared memory follows (the 8 ints of `Sched` in the
    CUDA source): n ints in all; the offsets of the owned-slot lists, the
    chunk records, the tracer records and the rails; nch chunks of at most
    `chunk` reconstructions; nslots kept values per cell."""
    n: int
    o_upd: int
    o_chk: int
    o_trc: int
    o_lohi: int
    nch: int
    chunk: int
    nslots: int


def smem_bytes(tx: int, ty: int, layout: Layout) -> int:
    """Shared memory of one block for the packed schedule `layout`
    describes: its n ints, 6 mass planes, a chunk's 3 x chunk
    reconstruction planes and two int lists on the (tx+2) x (ty+2) ring
    tile, `chunk` fluxes per edge thread, and nslots kept values plus 3
    mass values per cell. Mirrors transport_smem_bytes in the CUDA
    source."""
    R = (tx + 2) * (ty + 2)
    return 4 * (layout.n + (6 + 3 * layout.chunk) * R
                + layout.chunk * block_threads(tx, ty)
                + (layout.nslots + 3) * tx * ty + 2 * R)


def pick_tile(layout: Layout):
    """The first tile of TILES whose block fits shared memory."""
    for tx, ty in TILES:
        if smem_bytes(tx, ty, layout) <= MAX_SMEM:
            return tx, ty
    raise ValueError("fused transport kernel: a schedule of "
                     f"{layout.n} ints with {layout.nslots} kept values "
                     "exceeds the shared memory of the smallest tile")


class Schedule(NamedTuple):
    """Chunks of the flat table for the one-pass kernel. Chunk k holds the
    entries ch_start[k]:ch_start[k+1]; entry e reconstructs tracer
    ent_tr[e]; the first ch_nw1[k] entries of a chunk are of type 1 or 3,
    the rest of type 2; ent_own[e] is 1 where the chunk also fluxes and
    updates the tracer (0: an ancestor held for its dependents); ent_p /
    ent_g are the positions in the chunk of its parent's and grandparent's
    reconstructions (-1: none); vslot[n] numbers the tracers with
    dependents (-1: none), nslots of them; chunk is the largest chunk."""
    ch_start: tuple
    ch_nw1: tuple
    ent_tr: tuple
    ent_own: tuple
    ent_p: tuple
    ent_g: tuple
    vslot: tuple
    nslots: int
    chunk: int


def chain_order(table) -> list:
    """The tracers family by family: a type-1 tracer, then each of its
    children followed by its own children, in table order. Every tracer
    comes once, after its parent, and a tracer's descendants follow it
    without another tracer of its type between."""
    kids: list = [[] for _ in table]
    for k, f in enumerate(table):
        if f.parent >= 0:
            kids[f.parent].append(k)
    order: list = []

    def visit(n):
        order.append(n)
        for k in kids[n]:
            visit(k)
    for n, f in enumerate(table):
        if f.parent < 0:
            visit(n)
    return order


def build_schedule(table, budget: int = CHUNK) -> Schedule:
    """Cut the flat table into chunks of at most `budget` reconstructions
    that follow its dependency chains: tracers are taken in `chain_order`,
    so a tracer is fluxed and updated in the chunk of its parent or a later
    one, exactly once; a chunk also reconstructs the parents and
    grandparents its tracers need and does not own."""
    if budget < 3:
        raise ValueError("a chunk must hold a tracer, its parent and its "
                         "grandparent")
    par = [f.parent for f in table]

    def ancestors(n):
        out = []
        while par[n] >= 0 and len(out) < 2:
            n = par[n]
            out.append(n)
        return out

    chunks, own, ent = [], [], []
    for n in chain_order(table):
        need = [a for a in ancestors(n) if a not in ent] + [n]
        if len(ent) + len(need) > budget:
            chunks.append((own, ent))
            own, ent = [], []
            need = ancestors(n) + [n]
        ent += need
        own.append(n)
    if own:
        chunks.append((own, ent))

    ch_start, ch_nw1 = [0], []
    ent_tr, ent_own, ent_p, ent_g = [], [], [], []
    for own, ent in chunks:
        ent = sorted(ent, key=lambda n: (table[n].ttype == 2, n))
        slot = {n: k for k, n in enumerate(ent)}
        ch_nw1.append(sum(table[n].ttype != 2 for n in ent))
        for n in ent:
            anc = ancestors(n)
            ent_tr.append(n)
            ent_own.append(int(n in own))
            ent_p.append(slot[anc[0]] if anc else -1)
            ent_g.append(slot[anc[1]] if len(anc) > 1 else -1)
        ch_start.append(len(ent_tr))
    vslot, nslots = [], 0
    for f in table:
        vslot.append(nslots if f.has_dependents else -1)
        nslots += int(f.has_dependents)
    chunk = max(2, max(b - a for a, b in zip(ch_start, ch_start[1:])))
    return Schedule(*(tuple(v) for v in (ch_start, ch_nw1, ent_tr, ent_own,
                                         ent_p, ent_g, vslot)),
                    nslots, chunk)


def transport_plain(grid: Grid, mom_n, mom_e, am, trm, table):
    """Plain PyTorch version: construct_fields -> fluxes -> update."""
    mc, mx, my, tc, tx, ty, _ = construct_fields(grid, am, trm, table,
                                                 grid.hm)
    mflxe, mflxn, mtflxe, mtflxn = fluxes_from_moments(
        grid, mom_n, mom_e, mc, mx, my, tc, tx, ty, table)
    return update_pre_floor(grid, am, trm, mflxe, mflxn, mtflxe, mtflxn,
                            table)


@functools.lru_cache(maxsize=16)
def _table_tensors(table, device):
    ta = _TableArrays(table)
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return (i32(ta.ttype), i32(ta.par), i32(ta.gpar), f32(ta.lo),
            f32(ta.hi))


_GRID_PLANES: collections.OrderedDict = collections.OrderedDict()


def _grid_planes(grid: Grid):
    """(afn, afe, tarear, hm): the masked N and E edge areas and the two T
    planes the kernels read, contiguous f32, built once per grid. The last
    4 grids are kept, each beside its entry so that its id stays its own."""
    hit = _GRID_PLANES.get(id(grid))
    if hit is not None and hit[0] is grid:
        return hit[1]
    f32 = lambda t: t.to(torch.float32).contiguous()
    planes = (f32(grid.narea * grid.npm), f32(grid.earea * grid.epm),
              f32(grid.tarear), f32(grid.hm))
    _GRID_PLANES[id(grid)] = (grid, planes)
    while len(_GRID_PLANES) > 4:
        _GRID_PLANES.popitem(last=False)
    return planes


class PackedSchedule(NamedTuple):
    """The schedule and the flat table as the kernel reads them: one int32
    array `data` and its `layout`. data[0:4*nent] holds per entry (tracer, own | type << 1,
    parent's slot, grandparent's slot); from o_upd per chunk the slots of
    the entries it owns, sorted by chain type; from o_chk 8 ints per chunk
    (first entry, entries, entries of type 1 or 3, the 4 bounds of its
    types 1, 2, 3 in the list of owned slots, 0); from o_trc 4 ints per
    tracer (type, parent, grandparent, value slot); from o_lohi the lo and
    hi rails of each tracer as float32 bits."""
    data: np.ndarray
    layout: Layout


def pack_schedule(table, sch: Schedule) -> PackedSchedule:
    ta = _TableArrays(table)
    NT, nch = len(table), len(sch.ch_nw1)
    ent = [(n, own | table[n].ttype << 1, p, g) for n, own, p, g in
           zip(sch.ent_tr, sch.ent_own, sch.ent_p, sch.ent_g)]
    upd, chk = [], []
    for k in range(nch):
        e0, e1 = sch.ch_start[k], sch.ch_start[k + 1]
        bounds = [len(upd)]
        for tt in (1, 2, 3):
            upd += [s for s in range(e1 - e0) if sch.ent_own[e0 + s]
                    and table[sch.ent_tr[e0 + s]].ttype == tt]
            bounds.append(len(upd))
        chk.append((e0, e1 - e0, sch.ch_nw1[k], *bounds, 0))
    pad4 = lambda n: (n + 3) // 4 * 4
    o_upd = 4 * len(ent)
    o_chk = o_upd + pad4(len(upd))
    o_trc = o_chk + 8 * nch
    o_lohi = o_trc + 4 * NT
    n = pad4(o_lohi + 2 * NT)
    data = np.zeros(n, np.int32)
    data[:o_upd] = np.asarray(ent, np.int32).ravel()
    data[o_upd:o_upd + len(upd)] = upd
    data[o_chk:o_trc] = np.asarray(chk, np.int32).ravel()
    data[o_trc:o_lohi] = np.stack(
        [ta.ttype, np.where(ta.has_p, ta.par, -1),
         np.where(ta.has_g, ta.gpar, -1), sch.vslot], axis=1).ravel()
    data[o_lohi:o_lohi + 2 * NT] = np.stack(
        [ta.lo, ta.hi], axis=1).astype(np.float32).ravel().view(np.int32)
    return PackedSchedule(data, Layout(n, o_upd, o_chk, o_trc, o_lohi, nch,
                                       sch.chunk, sch.nslots))


@functools.lru_cache(maxsize=16)
def _schedule_tensors(table, device, budget: int = CHUNK):
    """(layout, the packed schedule's int array on the device)."""
    packed = pack_schedule(table, build_schedule(table, budget))
    return packed.layout, torch.as_tensor(packed.data, device=device)


def _lib():
    lib = load("transport_fused")
    lib.transport_fused.argtypes = [ctypes.c_void_p] * 9 + \
        [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_void_p] * 2 + \
        [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.transport_fused.restype = ctypes.c_int
    lib.transport_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_long,
                                   ctypes.POINTER(ctypes.c_int)]
    lib.transport_info.restype = ctypes.c_int
    return lib


def kernel_info(table, *, tile=None, budget: int = CHUNK) -> dict:
    """Tile, threads, shared memory and (from the CUDA runtime) registers
    per thread and resident blocks per SM of the one-pass kernel for this
    table, on the current CUDA device. tile, budget: as `transport_cuda`."""
    layout = pack_schedule(table, build_schedule(table, budget)).layout
    tx, ty = tile or pick_tile(layout)
    smem = smem_bytes(tx, ty, layout)
    info = (ctypes.c_int * 4)()
    check(_lib().transport_info(tx, ty, smem, info), "transport_info")
    return dict(tile=(tx, ty), threads=block_threads(tx, ty), smem=smem,
                chunks=layout.nch, chunk=layout.chunk, registers=info[0],
                blocks_per_sm=info[3])


def transport_cuda(grid: Grid, mom_n, mom_e, am, trm, table, *, tile=None,
                   budget: int = CHUNK):
    """The one-pass transport in CUDA; returns (am_pre, trm_new).

    tile, budget: None / CHUNK let `pick_tile` choose the tile for chunks
    of at most CHUNK reconstructions; a test or a measurement may name
    another tile of TILES or another chunk size."""
    global launches, chunk_launches
    if grid.bc.tripole or grid.bc.y_cyclic:
        raise NotImplementedError(
            "fused transport kernel: tripole/y-cyclic boundaries are not "
            "ported yet (ROADMAP A9: tripole and y-cyclic boundaries in "
            "K1-K3); remap_kernel='xla' runs the plain transport")
    ncat, NT, ny, nx = trm.shape
    if NT != len(table):
        raise ValueError(f"trm has {NT} tracers, the table {len(table)}")
    expect = {"trm": (trm, (ncat, NT, ny, nx)),
              "am": (am, (ncat + 1, ny, nx)),
              "mom_n": (mom_n, (6, 10, ny, nx)),
              "mom_e": (mom_e, (6, 10, ny, nx))}
    for name, (t, shape) in expect.items():
        if t.device != trm.device or t.dtype != torch.float32 or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"fused transport kernel: {name} must be a "
                             f"contiguous float32 tensor {shape} on "
                             f"{trm.device}, got {tuple(t.shape)} {t.dtype}"
                             f" on {t.device}")
    if grid.shape != (ny, nx):
        raise ValueError("fused transport kernel: grid shape mismatch")
    afn, afe, tarear, hm = _grid_planes(grid)
    x_cyclic, R = int(grid.bc.x_cyclic), 0
    if isinstance(grid.bc, TileBC):
        from ..parallel.evp_wide import padded_tiles
        R, x_cyclic = K2_RADIUS, 0
        trm, am, mom_n, mom_e, afn, afe, tarear, hm = padded_tiles(
            grid.bc, R, trm, am, mom_n, mom_e, afn, afe, tarear, hm)
        ny, nx = ny + 2 * R, nx + 2 * R
    layout, sched = _schedule_tensors(table, trm.device, budget)
    tx, ty = tile or pick_tile(layout)
    if (tx, ty) not in TILES or smem_bytes(tx, ty, layout) > MAX_SMEM:
        raise ValueError(f"fused transport kernel: tile {(tx, ty)} is not "
                         "one of TILES or does not fit shared memory")
    trm_new = torch.empty_like(trm)
    am_pre = torch.empty_like(am)
    stream = torch.cuda.current_stream(trm.device).cuda_stream
    ptrs = [t.data_ptr() for t in (trm, am, mom_n, mom_e, afn, afe, tarear,
                                   hm, sched)]
    err = _lib().transport_fused(
        *ptrs, (ctypes.c_int * 8)(*layout), trm_new.data_ptr(),
        am_pre.data_ptr(), ncat, NT, ny, nx, x_cyclic, tx, ty, stream)
    check(err, "transport_fused")
    launches += 1
    chunk_launches += layout.nch
    if R:
        am_pre, trm_new = _crop(R, am_pre, trm_new)
    return am_pre, trm_new


def transport_fused(grid: Grid, mom_n, mom_e, am, trm, table):
    """One-pass transport; returns (am_pre, trm_new)."""
    if not _on_cuda(trm):
        return transport_plain(grid, mom_n, mom_e, am, trm, table)
    return transport_cuda(grid, mom_n, mom_e, am, trm, table)


def tracer_fluxes_plain(grid: Grid, mom_n, mom_e, mc, mx, my, tc, tx, ty,
                        table, *, tstack=None):
    """Plain PyTorch version of the flux-only kernel."""
    return fluxes_from_moments(grid, mom_n, mom_e, mc, mx, my, tc, tx, ty,
                               table)


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


#: flux-only kernel (csrc/tracer_fluxes.cu): its tile (x, y), a thread per
#: (cell, edge family), so 2*x*y threads; its staging buffers; the plane
#: groups it stages per barrier by default
FLUX_TILE = (32, 2)
FLUX_STAGES = 3
FLUX_CHUNK = 8


def flux_smem_bytes(chunk: int = FLUX_CHUNK) -> int:
    """Dynamic shared memory of one flux-kernel block: FLUX_STAGES buffers
    of `chunk` plane groups of 3 planes on the ring tile around FLUX_TILE,
    and 3 ints per ring cell (mirrors smem_bytes in csrc/tracer_fluxes.cu)."""
    tx, ty = FLUX_TILE
    return 4 * (3 * FLUX_STAGES * chunk + 3) * (tx + 2) * (ty + 2)


def flux_order(table) -> np.ndarray:
    """(NT, 2) int32: per position of `chain_order`, the tracer and its
    type | has_dependents << 2. The flux kernel keeps the chain sums of the
    last type-1 and type-2 tracer with dependents in registers; in this
    order they are the parent and grandparent of every tracer that needs
    them."""
    return np.asarray([(n, table[n].ttype | int(table[n].has_dependents) << 2)
                       for n in chain_order(table)], np.int32).reshape(-1, 2)


@functools.lru_cache(maxsize=16)
def _flux_order_tensor(table, device):
    return torch.as_tensor(flux_order(table), device=device)


def _flux_lib():
    lib = load("tracer_fluxes")
    lib.tracer_fluxes.argtypes = [ctypes.c_void_p] * 13 + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.tracer_fluxes.restype = ctypes.c_int
    lib.tracer_fluxes_info.argtypes = [ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.tracer_fluxes_info.restype = ctypes.c_int
    return lib


def _flux_chunk(chunk: int) -> int:
    if chunk < 1 or flux_smem_bytes(chunk) > MAX_SMEM:
        raise ValueError(f"flux-only transport kernel: {chunk} plane groups "
                         "per chunk do not fit a block's shared memory")
    return chunk


def flux_kernel_info(chunk: int = FLUX_CHUNK) -> dict:
    """Tile, threads, staging, shared memory and (from the CUDA runtime)
    registers per thread and resident blocks per SM of the flux-only
    kernel on the current CUDA device, staging `chunk` plane groups per
    barrier."""
    info = (ctypes.c_int * 4)()
    check(_flux_lib().tracer_fluxes_info(_flux_chunk(chunk), info),
          "tracer_fluxes_info")
    return dict(tile=FLUX_TILE, threads=2 * FLUX_TILE[0] * FLUX_TILE[1],
                stages=FLUX_STAGES, chunk=chunk,
                smem=flux_smem_bytes(chunk) + info[1], registers=info[0],
                blocks_per_sm=info[3])


def _f32c(t: torch.Tensor) -> torch.Tensor:
    """`t` itself where it is contiguous f32, else a contiguous f32 copy."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def tracer_fluxes_cuda(grid: Grid, mom_n, mom_e, mc, mx, my, tc, tx, ty,
                       table, *, tstack=None, chunk: int = FLUX_CHUNK):
    """The flux-only kernel in CUDA; returns (mflxe, mflxn, mtflxe,
    mtflxn). tstack: the (ncat, 3*NT, ny, nx) [tc|tx|ty] stack
    `construct_fields` returns; without it the three are concatenated here.
    chunk: plane groups staged per barrier; a measurement may name another
    than FLUX_CHUNK."""
    global flux_launches
    if grid.bc.tripole or grid.bc.y_cyclic:
        raise NotImplementedError(
            "flux-only transport kernel: tripole/y-cyclic boundaries are not "
            "ported yet (ROADMAP A9: tripole and y-cyclic boundaries in "
            "K1-K3); remap_kernel='xla' runs the plain transport")
    if tc.dtype != torch.float32:
        raise ValueError("flux-only transport kernel is float32-only, got "
                         f"{tc.dtype}; use remap_kernel='xla'")
    _flux_chunk(chunk)
    if tstack is None:
        tstack = torch.cat([tc, tx, ty], dim=1)
    ncat, NT, ny, nx = tc.shape
    if NT != len(table):
        raise ValueError(f"tc has {NT} tracers, the table {len(table)}")
    tstack, mc, mx, my, mom_n, mom_e = (
        _f32c(t) for t in (tstack, mc, mx, my, mom_n, mom_e))
    expect = {"tstack": (tstack, (ncat, 3 * NT, ny, nx)),
              "mc": (mc, (ncat + 1, ny, nx)), "mx": (mx, (ncat + 1, ny, nx)),
              "my": (my, (ncat + 1, ny, nx)),
              "mom_n": (mom_n, (6, 10, ny, nx)),
              "mom_e": (mom_e, (6, 10, ny, nx))}
    for name, (t, shape) in expect.items():
        if t.device != tc.device or tuple(t.shape) != shape:
            raise ValueError(f"flux-only transport kernel: {name} must have "
                             f"shape {shape} on {tc.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if grid.shape != (ny, nx):
        raise ValueError("flux-only transport kernel: grid shape mismatch")
    if ny * nx >= 2 ** 31:
        raise ValueError("flux-only transport kernel: the grid is too large "
                         "for its 32-bit cell indices")
    afn, afe, _, _ = _grid_planes(grid)
    x_cyclic, R = int(grid.bc.x_cyclic), 0
    if isinstance(grid.bc, TileBC):
        from ..parallel.evp_wide import padded_tiles
        R, x_cyclic = K3_RADIUS, 0
        tstack, mc, mx, my, mom_n, mom_e, afn, afe = padded_tiles(
            grid.bc, R, tstack, mc, mx, my, mom_n, mom_e, afn, afe)
        ny, nx = ny + 2 * R, nx + 2 * R
    order = _flux_order_tensor(table, tc.device)
    mflxe = torch.empty_like(mc)
    mflxn = torch.empty_like(mc)
    mtflxe = torch.empty((ncat, NT, ny, nx), dtype=torch.float32,
                         device=tc.device)
    mtflxn = torch.empty_like(mtflxe)
    stream = torch.cuda.current_stream(tc.device).cuda_stream
    ptrs = [t.data_ptr() for t in (tstack, mc, mx, my, mom_n, mom_e, afn,
                                   afe, order, mflxe, mflxn, mtflxe,
                                   mtflxn)]
    err = _flux_lib().tracer_fluxes(*ptrs, ncat, NT, ny, nx, x_cyclic,
                                    chunk, stream)
    check(err, "tracer_fluxes")
    flux_launches += 1
    if R:
        return tuple(_crop(R, mflxe, mflxn, mtflxe, mtflxn))
    return mflxe, mflxn, mtflxe, mtflxn


def tracer_fluxes_fused(grid: Grid, mom_n, mom_e, mc, mx, my, tc, tx, ty,
                        table, *, tstack=None):
    """Mass and mass*tracer transports across E and N edges in one kernel
    launch; returns (mflxe, mflxn, mtflxe, mtflxn). On CPU tensors the
    plain version."""
    if not _on_cuda(tc):
        return tracer_fluxes_plain(grid, mom_n, mom_e, mc, mx, my, tc, tx,
                                   ty, table)
    return tracer_fluxes_cuda(grid, mom_n, mom_e, mc, mx, my, tc, tx, ty,
                              table, tstack=tstack)


#: flops of one tracer's candidate term by chain type in the one-pass
#: kernel (csrc/transport_fused.cu: 5 / 15+5 / 15+5+1, plus the
#: accumulation)
_CHAIN_FLOPS = {1: 6, 2: 21, 3: 22}


def _memo_flops(f) -> int:
    """Flops of one tracer's candidate term in the flux-only kernel
    (csrc/tracer_fluxes.cu), which keeps the chain sums: type 1 its sum (5)
    and, with dependents, the triple's two others (10); type 2 its sum from
    the parent's triple (5); type 3 one product; plus the accumulation."""
    return {1: 6 + 10 * int(f.has_dependents), 2: 6, 3: 2}[f.ttype]


def _edge_flops(table, ncat: int, cands: float = 6.0,
                chain=lambda f: _CHAIN_FLOPS[f.ttype]) -> float:
    """Flops of one edge of one cell over all categories with `cands`
    donor candidates that count: per candidate the six moment sums (30) and
    the mass sum, per tracer its candidate terms (`chain`) and the scaling
    by the edge area; the open-water row once."""
    return ncat * (cands * 31 + sum(cands * chain(f) + 2
                                    for f in table)) + cands * 6


def work_fractions(grid: Grid, mom_n, mom_e):
    """(active, needed): what the one-pass kernel's work depends on in the
    data. `active` is the mean number of donor candidates per edge with a
    nonzero moment (of 6; the others add exact zeros and are left out);
    `needed` is the share of cells that donate through such a candidate,
    the only ones whose tracer reconstruction is read.

    The flux-only kernel leaves out the same candidates, and loads the
    reconstructions (tracer and mass) of the `needed` cells only.

    On finite fields leaving these out changes no bit. A non-finite tracer
    in a cell that donates nothing stays in that cell in the one-pass
    kernel (its update keeps a NaN through the clip to the rails), while
    the plain version multiplies it by the zero moments and hands NaN to
    the neighbours; the cell itself is non-finite in both, so `check_state`
    flags such a state on either path. The flux-only kernel never reads a
    non-finite reconstruction of such a cell: its fluxes stay finite, equal
    bit for bit to the plain version's on the same fields with that value
    made finite, while the plain version's fluxes of the edges around the
    cell are NaN; the update that follows keeps the NaN in the cell, as it
    does on the plain path."""
    from ..core.halo import shift
    from ..dynamics.remap_exact import OFFS_E, OFFS_N
    ny, nx = mom_n.shape[-2:]
    need = torch.zeros((ny, nx), dtype=torch.bool, device=mom_n.device)
    nact = 0.0
    for mom, offs in ((mom_n, OFFS_N), (mom_e, OFFS_E)):
        act = (mom != 0).any(dim=1)
        nact += float(act.sum())
        for ci, (dj, di) in enumerate(offs):
            need |= shift(act[ci].to(mom.dtype), -dj, -di, bc=grid.bc) > 0
    return nact / (2 * ny * nx), float(need.sum()) / (ny * nx)


def tracer_fluxes_bound_bytes_flops(table, ncat: int, ny: int, nx: int,
                                    active: float = 6.0,
                                    needed: float = 1.0):
    """(bytes, flops) one flux pass must move and do, counted from
    csrc/tracer_fluxes.cu. Bytes: for the `needed` share of cells the
    reconstruction planes per category (tc, tx, ty of a type-1 or type-2
    tracer, tc alone of a type-3 one) and the 3 mass reconstruction planes
    per category and for open water; the 120 moment planes and 2 edge-area
    planes read once; the two families' mass (ncat+1) and tracer (ncat*NT)
    flux planes written once. Flops: 2 edges per cell with `active` donor
    candidates of 6 and the chain sums kept (`_memo_flops`). `active` and
    `needed` come from `work_fractions`; the defaults count every candidate
    and every cell."""
    NT = len(table)
    P = ny * nx
    recon = ncat * sum(1 if f.ttype == 3 else 3 for f in table)
    nbytes = 4 * P * (needed * (recon + 3 * (ncat + 1)) + 120 + 2
                      + 2 * (ncat * NT + ncat + 1))
    return nbytes, P * 2 * _edge_flops(table, ncat, active, _memo_flops)


def bound_bytes_flops(table, ncat: int, ny: int, nx: int,
                      active: float = 6.0, needed: float = 1.0):
    """(bytes, flops) one transport pass must move and do, counted from
    csrc/transport_fused.cu (a sqrt, divide, min or max counts as one).
    Bytes: trm, am, the 120 moment planes and 4 grid planes read once;
    trm_new and am_pre written once. Flops: each cell's mass
    reconstruction and, for the `needed` share of cells, its tracers'
    (limited gradient ~94 per field; type-2 tracers ~43 more for their
    centroid and mask), the fluxes across 2 edges per cell (`active`
    candidates of 6, per tracer 6 / 21 / 22 for chain types 1 / 2 / 3) and
    the update. `active` and `needed` come from `work_fractions`; the
    defaults count every candidate and every cell."""
    NT = len(table)
    P = ny * nx
    nbytes = 4 * P * (2 * ncat * NT + 2 * (ncat + 1) + 120 + 4)
    lim = 94
    ttypes = [f.ttype for f in table]
    recon = (ncat + 1) * (lim + 7) + needed * ncat * sum(
        {1: lim + 4, 2: lim + 43, 3: 0}[t] for t in ttypes)
    update = ncat * (NT * 11 + 6) + 3
    return nbytes, P * (recon + 2 * _edge_flops(table, ncat, active) + update)
