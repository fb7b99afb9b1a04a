"""Fused B-grid EVP subcycles: wrapper of the CUDA kernel csrc/evp_fused.cu.

`evp_solve_fused` keeps the signature and return tuple of
`dynamics.evp.evp_solve`. On CPU tensors it runs that plain PyTorch version;
on CUDA tensors it runs the `ndte` subcycles in the CUDA kernel (two
launches per subcycle, issued by one C call) and the final force
diagnostics (`evp_tail`) in PyTorch, as the TPU kernel leaves them to XLA.
It replaces cice_tpu/kernels/evp_pallas.py:evp_solve_fused.
"""

from __future__ import annotations

import ctypes

import torch

from .. import constants as cst
from ..core.grid import Grid
from ..dynamics.common import DynPrep, EvpParams
from ..dynamics.evp import evp_solve, evp_tail
from ._build import check, load

#: the 26 constant planes, in the kernel's C_* enum order
CONST_PLANES = ("dxT", "dyT", "cxm", "cxp", "cym", "cyp", "dxhy", "dyhx",
                "uarear", "iceTmask", "iceUmask", "aiU", "umassdti", "fm",
                "waterx", "watery", "forcex", "forcey", "uvel_init",
                "vvel_init", "Cw", "TbU", "strength", "DminTarea", "uocn",
                "vocn")
N_STATE = 14

#: times the CUDA kernel entry ran (each run = 2*ndte CUDA launches)
launches = 0


def pack_const(grid: Grid, prep: DynPrep, strength, DminTarea, uocn, vocn):
    """(26, ny, nx) f32 stack of the subcycle-invariant planes."""
    src = dict(strength=strength, DminTarea=DminTarea, uocn=uocn, vocn=vocn)
    planes = []
    for name in CONST_PLANES:
        if name in src:
            t = src[name]
        elif hasattr(prep, name):
            t = getattr(prep, name)
        else:
            t = getattr(grid, name)
        planes.append(t.to(torch.float32))
    return torch.stack(planes).contiguous()


def kernel_params(p: EvpParams):
    """The 15 scalars of the kernel's Params struct, rounded to f32 as
    the plain version's Python-float operands are."""
    vals = (p.e_factor, p.capping, 1.0 + p.Ktens, 1.0 - p.Ktens, p.epp2i,
            1.0 - p.arlx1i * p.revp, p.arlx1i, p.denom1, p.brlx + p.revp,
            p.brlx, p.revp, cst.rhow, cst.u0, cst.cosw, cst.sinw)
    return (ctypes.c_float * len(vals))(*vals)


def _lib():
    lib = load("evp_fused")
    lib.evp_subcycles.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
    lib.evp_subcycles.restype = ctypes.c_int
    return lib


def evp_subcycles_cuda(const: torch.Tensor, state: torch.Tensor,
                       p: EvpParams, x_cyclic: bool) -> torch.Tensor:
    """Run p.ndte subcycles of the CUDA kernel in place on `state`
    (14, ny, nx) given the (26, ny, nx) constant planes."""
    global launches
    for name, t, n in (("const", const, len(CONST_PLANES)),
                       ("state", state, N_STATE)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.dim() != 3 or t.shape[0] != n:
            raise ValueError(f"evp kernel: {name} must be a contiguous "
                             f"float32 CUDA tensor ({n}, ny, nx), got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if const.shape[1:] != state.shape[1:] or const.device != state.device:
        raise ValueError("evp kernel: const and state grids differ")
    _, ny, nx = state.shape
    # temporaries may be freed before the kernel runs: the caching
    # allocator reuses their memory only for later work on this
    # same stream, which the kernel precedes
    strbuf = torch.empty((8, ny, nx), dtype=torch.float32,
                         device=state.device)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    err = _lib().evp_subcycles(const.data_ptr(), state.data_ptr(),
                               strbuf.data_ptr(), ny, nx, int(x_cyclic),
                               int(p.ndte), kernel_params(p), stream)
    check(err, "evp_subcycles")
    launches += 1
    return state


def evp_solve_fused(grid: Grid, p: EvpParams, prep: DynPrep, strength,
                    stressp, stressm, stress12, *, uocn, vocn):
    """Drop-in for dynamics.evp.evp_solve running the subcycles in the
    CUDA kernel. Returns (uvel, vvel, stressp, stressm, stress12, strintx,
    strinty, taubx, tauby)."""
    if strength.device.type == "cpu":
        return evp_solve(grid, p, prep, strength, stressp, stressm,
                         stress12, uocn=uocn, vocn=vocn)
    if grid.bc.tripole or grid.bc.y_cyclic:
        raise NotImplementedError(
            "fused EVP kernel: tripole/y-cyclic boundaries are not ported "
            "yet (ROADMAP: tripole and y-cyclic boundaries)")
    for t in (strength, stressp, stressm, stress12, uocn, vocn, prep.uvel):
        if t.dtype != torch.float32:
            raise ValueError(f"fused EVP kernel is f32-only, got {t.dtype}")
    ny, nx = grid.shape
    if stressp.shape != (4, ny, nx) or strength.shape != (ny, nx):
        raise ValueError("fused EVP kernel: shape mismatch with the grid")
    DminTarea = p.deltaminEVP * grid.tarea
    m3 = prep.iceTmask[None]
    state = torch.cat([prep.uvel[None], prep.vvel[None],
                       torch.where(m3, stressp, 0.0),
                       torch.where(m3, stressm, 0.0),
                       torch.where(m3, stress12, 0.0)]).contiguous()
    const = pack_const(grid, prep, strength, DminTarea, uocn, vocn)
    evp_subcycles_cuda(const, state, p, grid.bc.x_cyclic)
    u, v = state[0], state[1]
    sp, sm, s12 = state[2:6], state[6:10], state[10:14]
    strintx, strinty, taubx, tauby = evp_tail(
        grid, p, prep, strength, DminTarea, u, v, sp, sm, s12)
    return u, v, sp, sm, s12, strintx, strinty, taubx, tauby


# floating-point operations per cell per subcycle of csrc/evp_fused.cu,
# counted from the source (a sqrt or a divide counts as one): the T-cell
# kernel ~412 (strain rates 92, Deltas 28, viscosities 28, relaxation
# targets 20, relaxation 48, stress-divergence terms 196), the U-cell
# kernel ~58
FLOPS_PER_CELL_SUBCYCLE = 470


def bound_bytes_flops(ny: int, nx: int, ndte: int):
    """(bytes, flops) one subcycle loop must move and do: the 26 constant
    and 14 state planes read once, the 14 state planes written once."""
    planes = len(CONST_PLANES) + 2 * N_STATE
    return 4 * planes * ny * nx, FLOPS_PER_CELL_SUBCYCLE * ndte * ny * nx
