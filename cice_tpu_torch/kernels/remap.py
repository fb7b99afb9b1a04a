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

On CPU tensors each wrapper runs its plain PyTorch version
(`transport_plain`, `tracer_fluxes_plain`); on CUDA tensors it launches its
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.grid import Grid
from ..dynamics.remap_exact import (_TableArrays, construct_fields,
                                    fluxes_from_moments, update_pre_floor)
from ._build import check, load

#: times the one-pass transport kernel was launched
launches = 0
#: times the flux-only kernel was launched
flux_launches = 0

# thread-block tiles (x, y) in order of preference: the first whose shared
# memory fits takes it (smaller tiles let larger tracer tables fit)
TILES = ((32, 4), (32, 2), (32, 1), (16, 1), (8, 1))
MAX_SMEM = 232448          # bytes a block may use on sm_90


def smem_bytes(tx: int, ty: int, NT: int) -> int:
    """Shared memory of one block: 6 mass + 3*NT tracer reconstruction
    planes on the (tx+2) x (ty+2) ring tile, NT divergence slots per
    thread (mirrors transport_smem_bytes in the CUDA source)."""
    return 4 * ((6 + 3 * NT) * (tx + 2) * (ty + 2) + NT * tx * ty)


def pick_tile(NT: int):
    for tx, ty in TILES:
        if smem_bytes(tx, ty, NT) <= MAX_SMEM:
            return tx, ty
    raise ValueError(f"fused transport kernel: {NT} tracers exceed the "
                     "shared memory of the smallest tile")


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


def _lib():
    lib = load("transport_fused")
    lib.transport_fused.argtypes = [ctypes.c_void_p] * 15 + \
        [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.transport_fused.restype = ctypes.c_int
    return lib


def transport_fused(grid: Grid, mom_n, mom_e, am, trm, table):
    """One-pass transport; returns (am_pre, trm_new)."""
    global launches
    if trm.device.type == "cpu":
        return transport_plain(grid, mom_n, mom_e, am, trm, table)
    if grid.bc.tripole or grid.bc.y_cyclic:
        raise NotImplementedError(
            "fused transport kernel: tripole/y-cyclic boundaries are not "
            "ported yet (ROADMAP: tripole and y-cyclic boundaries)")
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
    # temporaries may be freed before the kernel runs: the caching
    # allocator reuses their memory only for later work on this
    # same stream, which the kernel precedes
    f32 = lambda t: t.to(torch.float32).contiguous()
    afn = f32(grid.narea * grid.npm)
    afe = f32(grid.earea * grid.epm)
    tarear = f32(grid.tarear)
    hm = f32(grid.hm)
    ttype, par, gpar, lo, hi = _table_tensors(table, trm.device)
    tx, ty = pick_tile(NT)
    trm_new = torch.empty_like(trm)
    am_pre = torch.empty_like(am)
    stream = torch.cuda.current_stream(trm.device).cuda_stream
    ptrs = [t.data_ptr() for t in (trm, am, mom_n, mom_e, afn, afe, tarear,
                                   hm, ttype, par, gpar, lo, hi, trm_new,
                                   am_pre)]
    err = _lib().transport_fused(*ptrs, ncat, NT, ny, nx,
                                 int(grid.bc.x_cyclic), tx, ty, stream)
    check(err, "transport_fused")
    launches += 1
    return am_pre, trm_new


def tracer_fluxes_plain(grid: Grid, mom_n, mom_e, mc, mx, my, tc, tx, ty,
                        table, *, tstack=None):
    """Plain PyTorch version of the flux-only kernel."""
    return fluxes_from_moments(grid, mom_n, mom_e, mc, mx, my, tc, tx, ty,
                               table)


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _flux_lib():
    lib = load("tracer_fluxes")
    lib.tracer_fluxes.argtypes = [ctypes.c_void_p] * 15 + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tracer_fluxes.restype = ctypes.c_int
    return lib


def tracer_fluxes_fused(grid: Grid, mom_n, mom_e, mc, mx, my, tc, tx, ty,
                        table, *, tstack=None):
    """Mass and mass*tracer transports across E and N edges in one kernel
    launch; returns (mflxe, mflxn, mtflxe, mtflxn). tstack: the
    (ncat, 3*NT, ny, nx) [tc|tx|ty] stack `construct_fields` returns;
    without it the three are concatenated here."""
    global flux_launches
    if not _on_cuda(tc):
        return tracer_fluxes_plain(grid, mom_n, mom_e, mc, mx, my, tc, tx,
                                   ty, table)
    if grid.bc.tripole or grid.bc.y_cyclic:
        raise NotImplementedError(
            "flux-only transport kernel: tripole/y-cyclic boundaries are not "
            "ported yet (ROADMAP A3: tripole and y-cyclic boundaries)")
    if tc.dtype != torch.float32:
        raise ValueError("flux-only transport kernel is float32-only, got "
                         f"{tc.dtype}; use remap_kernel='xla'")
    if tstack is None:
        tstack = torch.cat([tc, tx, ty], dim=1)
    ncat, NT, ny, nx = tc.shape
    if NT != len(table):
        raise ValueError(f"tc has {NT} tracers, the table {len(table)}")
    f32 = lambda t: t.to(torch.float32).contiguous()
    tstack, mc, mx, my, mom_n, mom_e = (
        f32(t) for t in (tstack, mc, mx, my, mom_n, mom_e))
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
    # temporaries may be freed before the kernel runs: see transport_fused
    afn = f32(grid.narea * grid.npm)
    afe = f32(grid.earea * grid.epm)
    ttype, par, gpar, _, _ = _table_tensors(table, tc.device)
    mflxe = torch.empty_like(mc)
    mflxn = torch.empty_like(mc)
    mtflxe = torch.empty_like(tc, memory_format=torch.contiguous_format)
    mtflxn = torch.empty_like(mtflxe)
    stream = torch.cuda.current_stream(tc.device).cuda_stream
    ptrs = [t.data_ptr() for t in (tstack, mc, mx, my, mom_n, mom_e, afn,
                                   afe, ttype, par, gpar, mflxe, mflxn,
                                   mtflxe, mtflxn)]
    err = _flux_lib().tracer_fluxes(*ptrs, ncat, NT, ny, nx,
                                    int(grid.bc.x_cyclic), stream)
    check(err, "tracer_fluxes")
    flux_launches += 1
    return mflxe, mflxn, mtflxe, mtflxn


#: flops of one tracer's candidate term by chain type (the sums of
#: csrc/*.cu: 5 / 15+5 / 15+5+1, plus the accumulation)
_CHAIN_FLOPS = {1: 6, 2: 21, 3: 22}


def _edge_flops(table, ncat: int) -> int:
    """Flops of one edge of one cell over all categories: per candidate the
    six moment sums (30) and the mass sum, per tracer its 6 candidate terms
    and the scaling by the edge area; the open-water row once."""
    return ncat * (6 * 31 + sum(6 * _CHAIN_FLOPS[f.ttype] + 2
                                for f in table)) + 6 * 6


def tracer_fluxes_bound_bytes_flops(table, ncat: int, ny: int, nx: int):
    """(bytes, flops) one flux pass must move and do, counted from
    csrc/tracer_fluxes.cu. Bytes: the 3*NT reconstruction planes per
    category, the 3 mass reconstruction planes per category and for open
    water, the 120 moment planes and 2 edge-area planes read once; the two
    families' mass (ncat+1) and tracer (ncat*NT) flux planes written once.
    Flops: 2 edges per cell."""
    NT = len(table)
    P = ny * nx
    nbytes = 4 * P * (3 * ncat * NT + 3 * (ncat + 1) + 120 + 2
                      + 2 * (ncat * NT + ncat + 1))
    return nbytes, P * 2 * _edge_flops(table, ncat)


def bound_bytes_flops(table, ncat: int, ny: int, nx: int):
    """(bytes, flops) one transport pass must move and do, counted from
    csrc/transport_fused.cu (a sqrt, divide, min or max counts as one).
    Bytes: trm, am, the 120 moment planes and 4 grid planes read once;
    trm_new and am_pre written once. Flops: each cell's reconstruction
    (limited gradient ~94 per field; type-2 tracers ~43 more for their
    centroid and mask), the fluxes across 2 edges per cell (6 candidates,
    per tracer 6 / 21 / 22 for chain types 1 / 2 / 3) and the update."""
    NT = len(table)
    P = ny * nx
    nbytes = 4 * P * (2 * ncat * NT + 2 * (ncat + 1) + 120 + 4)
    lim = 94
    ttypes = [f.ttype for f in table]
    recon = (ncat + 1) * (lim + 7) + ncat * sum(
        {1: lim + 4, 2: lim + 43, 3: 0}[t] for t in ttypes)
    update = ncat * (NT * 11 + 6) + 3
    return nbytes, P * (recon + 2 * _edge_flops(table, ncat) + update)
