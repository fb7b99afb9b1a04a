"""Fused B-grid EVP solve: wrapper of the CUDA kernels csrc/evp_fused.cu.

`evp_solve_fused` keeps the signature and return tuple of
`dynamics.evp.evp_solve`. On CPU tensors it runs that plain PyTorch version;
on CUDA tensors the whole solve (masking of the incoming stresses, the
`ndte` subcycles, the final force diagnostics) runs in CUDA, on one of two
routes that `choose_route` picks from the grid and the card:

- `persistent`: one cooperative launch whose blocks keep their tiles in
  shared memory for all subcycles and exchange a one-cell ring of u, v once
  per subcycle;
- `stream`: two launches per subcycle with the state in global memory, for
  grids whose tiles cannot all be resident.

Neither route knows a tripole fold or a y-cyclic wrap, and both are
float32: on CUDA tensors such a grid or dtype raises (ROADMAP A9), and a
launch that the card refuses raises; no route and no plain version stands
in for the kernel there. It replaces
cice_tpu/kernels/evp_pallas.py:evp_solve_fused.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import constants as cst
from ..core.grid import Grid
from ..dynamics.common import DynPrep, EvpParams
from ..dynamics.evp import evp_solve
from ._build import check, load

#: the 26 input planes, in the kernel's C_* enum order
CONST_PLANES = ("dxT", "dyT", "cxm", "cxp", "cym", "cyp", "dxhy", "dyhx",
                "uarear", "iceTmask", "iceUmask", "aiU", "umassdti", "fm",
                "waterx", "watery", "forcex", "forcey", "uvel_init",
                "vvel_init", "Cw", "TbU", "strength", "DminTarea", "uocn",
                "vocn")
MASK_PLANES = ("iceTmask", "iceUmask")
#: output planes: u, v, 3 x 4 stresses, strintx, strinty, taubx, tauby
N_OUT = 18

#: times a solve ran in CUDA (either route), and on each route
launches = 0
persistent_launches = 0
stream_launches = 0

# the persistent kernel's block: one thread per T cell of its tile, so also
# the most T cells a tile may have
PERSIST_THREADS = 1024


def persistent_smem_bytes(th: int, tw: int) -> int:
    """Shared memory of one persistent block with a (th, tw) tile: per
    thread 12 stresses, 10 T-cell and 14 U-cell constants and the 8
    stress-divergence terms, and u, v on the (th+2) x (tw+2) ring tile
    (mirrors persist_smem_bytes in the CUDA source)."""
    return 4 * ((12 + 10 + 14 + 8) * PERSIST_THREADS
                + 2 * (th + 2) * (tw + 2))


def choose_route(ny: int, nx: int, sm_count: int, smem_per_block: int,
                 blocks_per_sm: int):
    """('persistent', (th, tw)) or ('stream', None) for an (ny, nx) grid on
    a card with `sm_count` SMs that keeps `blocks_per_sm` blocks of the
    persistent kernel resident on each, `smem_per_block` bytes of shared
    memory a block.

    The persistent route needs every tile's block resident at once, a
    thread for each of the tile's (th+1) x (tw+1) T cells, and the tile in
    shared memory. Among the even splits that allow it, it takes the one
    with the fewest warps of T cells in a block (a subcycle takes as long
    as its largest block), then the fewest blocks (the barrier)."""
    resident = sm_count * blocks_per_sm
    best = None
    for nby in range(1, min(ny, resident) + 1):
        th = -(-ny // nby)
        if -(-ny // th) != nby:
            continue                    # the same tile as a smaller split
        for nbx in range(1, min(nx, resident // nby) + 1):
            tw = -(-nx // nbx)
            cells = (th + 1) * (tw + 1)
            if -(-nx // tw) != nbx or cells > PERSIST_THREADS or \
                    persistent_smem_bytes(th, tw) > smem_per_block:
                continue
            key = (-(-cells // 32), nby * nbx)
            if best is None or key < best[0]:
                best = (key, (th, tw))
    if best is None:
        return "stream", None
    return "persistent", best[1]


def kernel_params(p: EvpParams):
    """The 15 scalars of the kernel's Params struct, rounded to f32 as
    the plain version's Python-float operands are."""
    vals = (p.e_factor, p.capping, 1.0 + p.Ktens, 1.0 - p.Ktens, p.epp2i,
            1.0 - p.arlx1i * p.revp, p.arlx1i, p.denom1, p.brlx + p.revp,
            p.brlx, p.revp, cst.rhow, cst.u0, cst.cosw, cst.sinw)
    return (ctypes.c_float * len(vals))(*vals)


def _lib():
    lib = load("evp_fused")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fparams = ctypes.POINTER(ctypes.c_float)
    lib.evp_persistent_info.argtypes = [ctypes.POINTER(i32)]
    lib.evp_solve_persistent.argtypes = [
        ctypes.POINTER(ptr), ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
        fparams, ptr]
    lib.evp_solve_stream.argtypes = [
        ctypes.POINTER(ptr), ptr, ptr, i32, i32, i32, i32, fparams, ptr]
    for fn in (lib.evp_persistent_info, lib.evp_solve_persistent,
               lib.evp_solve_stream):
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=8)
def device_info(device_index: int) -> dict:
    """What the card offers the persistent kernel (from the CUDA runtime):
    sm_count, smem_per_block, blocks_per_sm for `choose_route`, and the
    kernel's registers per thread and threads per block."""
    info = (ctypes.c_int * 6)()
    with torch.cuda.device(device_index):
        check(_lib().evp_persistent_info(info), "evp_persistent_info")
    if not info[5]:
        raise RuntimeError("fused EVP kernel: the device takes no "
                           "cooperative launches")
    if info[4] != PERSIST_THREADS:
        raise RuntimeError("fused EVP kernel: the CUDA source and its wrapper "
                           "disagree on the block size")
    return dict(sm_count=info[0], smem_per_block=info[1],
                blocks_per_sm=info[2], registers=info[3], threads=info[4])


def _input_planes(grid: Grid, prep: DynPrep, strength, DminTarea, uocn, vocn):
    """The 26 planes where they lie: f32 (bool for the two masks),
    contiguous; a plane of another type is converted."""
    src = dict(strength=strength, DminTarea=DminTarea, uocn=uocn, vocn=vocn)
    planes = []
    for name in CONST_PLANES:
        if name in src:
            t = src[name]
        elif hasattr(prep, name):
            t = getattr(prep, name)
        else:
            t = getattr(grid, name)
        want = torch.bool if name in MASK_PLANES else torch.float32
        planes.append(t.to(want).contiguous())
    return planes


def evp_solve_cuda(grid: Grid, p: EvpParams, prep: DynPrep, strength,
                   stressp, stressm, stress12, *, uocn, vocn, route=None,
                   tile=None):
    """The whole solve in CUDA; returns the (18, ny, nx) output planes
    (u, v, stressp, stressm, stress12, strintx, strinty, taubx, tauby).

    route, tile: None lets `choose_route` pick from the grid and the card;
    a test or a measurement may name them."""
    global launches, persistent_launches, stream_launches
    if grid.bc.tripole or grid.bc.y_cyclic:
        raise NotImplementedError(
            "fused EVP kernel: tripole/y-cyclic boundaries are not ported "
            "yet (ROADMAP A9: tripole and y-cyclic boundaries in K1-K3); "
            "evp_algorithm='standard_2d' runs the plain loop")
    ny, nx = grid.shape
    dev = strength.device
    f32 = (strength, stressp, stressm, stress12, uocn, vocn, prep.uvel,
           prep.vvel)
    for t in f32:
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError("fused EVP kernel is f32-only on one CUDA "
                             f"device, got {t.dtype} on {t.device}")
    for t in (stressp, stressm, stress12):
        if tuple(t.shape) != (4, ny, nx):
            raise ValueError("fused EVP kernel: stresses must be "
                             f"(4, {ny}, {nx}), got {tuple(t.shape)}")
    if tuple(strength.shape) != (ny, nx) or dev.type != "cuda":
        raise ValueError("fused EVP kernel: strength must be a CUDA tensor "
                         "of the grid's shape")
    ndte = int(p.ndte)
    DminTarea = p.deltaminEVP * grid.tarea
    # temporaries may be freed before the kernels run: the caching
    # allocator reuses their memory only for later work on this same
    # stream, which the kernels precede
    planes = _input_planes(grid, prep, strength, DminTarea, uocn, vocn)
    planes += [t.contiguous() for t in (prep.uvel, prep.vvel, stressp,
                                        stressm, stress12)]
    for t in planes:
        if tuple(t.shape[-2:]) != (ny, nx) or t.device != dev:
            raise ValueError("fused EVP kernel: a plane does not match the "
                             "grid or lies on another device")
    ptrs = (ctypes.c_void_p * len(planes))(*[t.data_ptr() for t in planes])
    if route is None:
        info = device_info(dev.index or 0)
        route, tile = choose_route(ny, nx, info["sm_count"],
                                   info["smem_per_block"],
                                   info["blocks_per_sm"])
    out = torch.empty((N_OUT, ny, nx), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    if route == "persistent":
        th, tw = tile
        if (th + 1) * (tw + 1) > PERSIST_THREADS:
            raise ValueError(f"fused EVP kernel: a {th}x{tw} tile has more "
                             f"than {PERSIST_THREADS} T cells")
        halo = torch.empty((4, ny, nx), dtype=torch.float32, device=dev)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        err = lib.evp_solve_persistent(
            ptrs, out.data_ptr(), halo.data_ptr(), counter.data_ptr(), ny,
            nx, int(grid.bc.x_cyclic), ndte, th, tw, kernel_params(p),
            stream)
        check(err, f"evp_solve_persistent (tile {th}x{tw}, "
                   f"{-(-ny // th) * -(-nx // tw)} blocks)")
        persistent_launches += 1
    elif route == "stream":
        strbuf = torch.empty((8, ny, nx), dtype=torch.float32, device=dev)
        err = lib.evp_solve_stream(ptrs, out.data_ptr(), strbuf.data_ptr(),
                                   ny, nx, int(grid.bc.x_cyclic), ndte,
                                   kernel_params(p), stream)
        check(err, "evp_solve_stream")
        stream_launches += 1
    else:
        raise ValueError(f"fused EVP kernel: route {route!r}: expected "
                         "'persistent' or 'stream'")
    launches += 1
    return out


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def evp_solve_fused(grid: Grid, p: EvpParams, prep: DynPrep, strength,
                    stressp, stressm, stress12, *, uocn, vocn):
    """Drop-in for dynamics.evp.evp_solve running the solve in CUDA.
    Returns (uvel, vvel, stressp, stressm, stress12, strintx, strinty,
    taubx, tauby). CPU tensors run the plain `evp_solve`; on CUDA tensors
    the kernel runs, or `evp_solve_cuda` raises for a grid or dtype it
    cannot take. A run that wants the plain loop there names it
    (evp_algorithm='standard_2d')."""
    if not _on_cuda(strength):
        return evp_solve(grid, p, prep, strength, stressp, stressm,
                         stress12, uocn=uocn, vocn=vocn)
    return unpack_outputs(evp_solve_cuda(grid, p, prep, strength, stressp,
                                         stressm, stress12, uocn=uocn,
                                         vocn=vocn))


def unpack_outputs(out):
    """The nine outputs of `evp_solve` as views of the (18, ny, nx) planes
    `evp_solve_cuda` returns."""
    return (out[0], out[1], out[2:6], out[6:10], out[10:14], out[14],
            out[15], out[16], out[17])


# floating-point operations per cell of csrc/evp_fused.cu, counted from
# the source (a sqrt or a divide counts as one): the T-cell pass ~412
# (strain rates 92, Deltas 28, viscosities 28, relaxation targets 20,
# relaxation 48, stress-divergence terms 196), the U-cell pass ~58
T_FLOPS, U_FLOPS = 412, 58
FLOPS_PER_CELL_SUBCYCLE = T_FLOPS + U_FLOPS


def bound_bytes_flops(ny: int, nx: int, ndte: int):
    """(bytes, flops) one solve must move and do: the 26 input planes (the
    two masks one byte a cell), the incoming u, v and 12 stresses read
    once, the 18 output planes written once; ndte subcycles and the tail's
    stress pass."""
    nbytes = (4 * (len(CONST_PLANES) - 2 + 14 + N_OUT) + 2) * ny * nx
    return nbytes, (FLOPS_PER_CELL_SUBCYCLE * ndte + T_FLOPS) * ny * nx
