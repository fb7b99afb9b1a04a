"""BL99 temperature solve of therm1: wrapper of the CUDA kernel K4,
csrc/bl99_column.cu.

`temperature_changes_cuda` keeps the signature of
`columns.thermo_vertical.temperature_changes` for ktherm=1 and returns its
outputs plus the pass count as a device int32 (never read on the host).
`choose_route` picks the route from what the caller hands it, with no
knob:

- `whole`: CUDA tensors and no mesh. One cooperative launch runs every
  Picard pass and decides the exit on the card (a grid barrier a pass),
  then the epilogue: no host read, and a launch count that does not depend
  on the pass count;
- `per_pass`: CUDA tensors on a rank's tile of a sharded state. The exit
  must be agreed across ranks, so one launch runs one pass and
  `host_read("picard", ..., mesh)` agrees it as the plain version does,
  then one launch runs the epilogue;
- None: CPU tensors, or ktherm=2 (mushy, another algorithm): the plain
  `temperature_changes_plain`.

Both routes equal the plain version bit for bit, pass count included. The
kernel takes float32 and float64 and the (nslyr, nilyr) it is built for
(`SHAPES`); any other shape raises on CUDA tensors, with no fallback.
Launches are counted by route in `whole_launches` and `per_pass_launches`
(read with the other kernels' counters by `kernels.launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import constants as cst
from ..columns import atmo
from ..columns import thermo_vertical as tv
from ..core.reductions import host_read
from ._build import check, load

#: (nslyr, nilyr) the library is built for (BL99_SHAPES in the source)
SHAPES = ((1, 7), (3, 7), (5, 7), (1, 1))
#: the column inputs, in the kernel's I_* order; then qsno, qice, Iswabs
INPUTS = ("Tsf", "hilyr", "hslyr", "Tbot", "fswsfc", "shcoef", "lhcoef",
          "potT", "Qa", "rhoa", "flw")
#: the output planes, in the kernel's O_* order; then Tsno, Tice,
#: qsno_new, qice_new
OUTPUTS = ("Tsf", "fsurf", "fcondtop", "fcondbot", "fsens", "flat",
           "flwout", "einit", "efinal", "keff_top")
CONDUCT = {"bubbly": 0, "MU71": 1}
#: threads of a block (THREADS in the source)
THREADS = 256
_SHAPE_ERROR = -1

#: launches on route 'whole' (one a solve) and on 'per_pass' (one a
#: pass and one for the epilogue)
whole_launches = 0
per_pass_launches = 0


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def choose_route(Tsf: torch.Tensor, ktherm: int, mesh):
    """'whole', 'per_pass' or None (the plain version) for a solve of
    `Tsf`'s columns under `ktherm` on a rank's tile of `mesh` (None: the
    whole grid in one process)."""
    if ktherm != 1 or not _on_cuda(Tsf):
        return None
    return "whole" if mesh is None else "per_pass"


def _lib():
    lib = load("bl99_column")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bl99_info.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
    lib.bl99_solve.argtypes = [
        i32, i32, i32, ctypes.POINTER(ptr), ctypes.POINTER(ctypes.c_longlong),
        ptr, ctypes.POINTER(ctypes.c_double), i32, i32, i32, i32, i32, i32,
        ptr, i32, ptr]
    for fn in (lib.bl99_info, lib.bl99_solve):
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=16)
def device_info(device_index: int, f64: bool, nslyr: int,
                nilyr: int) -> dict:
    """What the card offers the kernel of one instance in a cooperative
    launch: sm_count, blocks_per_sm, registers, threads."""
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(device_index):
        check(_lib().bl99_info(int(f64), nslyr, nilyr, info), "bl99_info")
    if not info[4]:
        raise RuntimeError("BL99 kernel: the device takes no cooperative "
                           "launches")
    if info[3] != THREADS:
        raise RuntimeError("BL99 kernel: the CUDA source and its wrapper "
                           "disagree on the block size")
    return dict(sm_count=info[0], blocks_per_sm=info[1], registers=info[2],
                threads=info[3])


@functools.lru_cache(maxsize=32)
def kernel_consts(dtype: torch.dtype, dt: float, nslyr: int, salin: tuple,
                  Tm: tuple, conduct: str, errmax: float):
    """The kernel's constants as the plain version's PyTorch ops see them
    on the card, each rounded to `dtype`: a Python scalar operand rounded
    once; `tensor / scalar` as a multiply by the reciprocal, rounded in
    the dtype; products of Python floats folded in double first, as
    Python evaluates them. The values are the plain version's own names
    (columns/thermo_vertical.py, columns/atmo.py, constants.py). A ctypes
    array of doubles (CONSTS order, then LAYER_CONSTS rows of nilyr
    values)."""
    f = np.float32 if dtype == torch.float32 else np.float64
    r = lambda x: float(f(x))
    inv = lambda x: float(f(1.0) / f(x))
    mu71 = conduct == "MU71"
    scalars = [
        r(dt), r(nslyr), r(cst.hs_min), r(cst.puny), inv(cst.rhos),
        r(cst.Lfresh), inv(cst.cp_ice), inv(cst.rhoi), inv(2.0 * cst.cp_ice),
        r(2.0 * cst.ksno), r(cst.ksno), r(nslyr + 1.0),
        r(cst.rhos * cst.cp_ice), r(cst.cp_ice), r(tv.CI_MIN),
        r(cst.rhoi), r(cst.Tffresh), r(cst.qqqice), r(-cst.TTTice),
        r(cst.TTTice), r(-cst.emissivity * cst.stefan_boltzmann),
        r(-4.0 * cst.emissivity * cst.stefan_boltzmann), r(cst.emissivity),
        r(atmo.RHOA_MIN), r(atmo.TSFK_MIN), r(tv.TT_MIN), r(tv.DENOM_MIN),
        r(errmax), r(-cst.rhos), r(-cst.rhoi), r(cst.kimin),
        r(cst.kice if mu71 else tv.BUBBLY_K0), r(tv.BUBBLY_KT),
        r(cst.rhoi / tv.BUBBLY_RHOI), r(tv.T_COND_MAX), r(cst.Tsmelt),
        r(tv.T_MIN)]
    layers = [
        [r(t) for t in Tm],
        [r(t - tv.TM_MARGIN) for t in Tm],
        [r((cst.cp_ocn - cst.cp_ice) * t) for t in Tm],
        [r(4.0 * cst.cp_ice * (cst.Lfresh * t)) for t in Tm],
        [r(cst.Lfresh * t) for t in Tm],
        [r(cst.cp_ocn * t) for t in Tm],
        [r((cst.betak if mu71 else tv.BUBBLY_KS) * s) for s in salin]]
    vals = scalars + [v for row in layers for v in row]
    return (ctypes.c_double * len(vals))(*vals)


def _broadcast_shape(shapes) -> tuple:
    """The shapes broadcast together. (`torch.broadcast_shapes` imports
    sympy on its first call: ~4 s of a process's set-up.)"""
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for i, n in enumerate(s, nd - len(s)):
            if n != 1:
                if out[i] not in (1, n):
                    raise ValueError("BL99 kernel: inputs of shapes "
                                     f"{[tuple(x) for x in shapes]} do not "
                                     "broadcast")
                out[i] = n
    return tuple(out)


def _plane_views(tensors, shape):
    """Each input broadcast to `shape` as (pointer, category stride): the
    last two dimensions must lie contiguous, the leading ones collapse to
    one stride (0 where the input has one plane for all). An input that
    does not fit is copied out whole (its pointer lives in the list)."""
    keep, ptrs, strides = [], [], []
    nd = len(shape)
    for t in tensors:
        v = t.broadcast_to(shape)
        st = v.stride()
        if nd == 1:
            fits = st[0] == 1 or shape[0] == 1
        else:
            fits = nd <= 3 and (st[-1] == 1 or shape[-1] == 1) and \
                (st[-2] == shape[-1] or shape[-2] == 1)
        lead = st[0] if nd == 3 else 0
        if not fits:
            v = v.contiguous()
            lead = shape[-2] * shape[-1] if nd >= 3 else 0
        keep.append(v)
        ptrs.append(v.data_ptr())
        strides.append(lead)
    return keep, ptrs, strides


def temperature_changes_cuda(dt, nilyr, nslyr, *, Tsf, qsno, qice, salin,
                             Tm, hilyr, hslyr, Tbot, fswsfc, Iswabs, shcoef,
                             lhcoef, potT, Qa, rhoa, flw, conduct="bubbly",
                             nit=20, mesh=None, route=None):
    """The ktherm=1 solve in CUDA on `route` ('whole', 'per_pass'; None:
    `choose_route`'s). Returns (TempSolveOut, qsno_new, qice_new, npass)
    with npass the passes run, a 0-d int32 on the card."""
    global whole_launches, per_pass_launches
    if route is None:
        route = "whole" if mesh is None else "per_pass"
    if route not in ("whole", "per_pass"):
        raise ValueError(f"BL99 kernel: route {route!r}: expected 'whole' "
                         "or 'per_pass'")
    if (nslyr, nilyr) not in SHAPES:
        raise ValueError(f"BL99 kernel: nslyr={nslyr}, nilyr={nilyr} is not "
                         f"built (csrc/bl99_column.cu BL99_SHAPES: "
                         f"(nslyr, nilyr) in {SHAPES})")
    if conduct not in CONDUCT:
        raise ValueError(f"BL99 kernel: conduct {conduct!r}")
    salin, Tm = list(salin), list(Tm)
    if isinstance(salin[0], torch.Tensor) or isinstance(Tm[0], torch.Tensor):
        raise ValueError("BL99 kernel: ktherm=1 takes the layer salinity "
                         "and melting temperature as numbers")
    if len(qsno) != nslyr or len(qice) != nilyr or len(Iswabs) != nilyr \
            or len(salin) != nilyr or len(Tm) != nilyr:
        raise ValueError("BL99 kernel: a layer list does not match "
                         f"nslyr={nslyr}, nilyr={nilyr}")
    named = dict(Tsf=Tsf, hilyr=hilyr, hslyr=hslyr, Tbot=Tbot,
                 fswsfc=fswsfc, shcoef=shcoef, lhcoef=lhcoef, potT=potT,
                 Qa=Qa, rhoa=rhoa, flw=flw)
    dev, dtype = Tsf.device, Tsf.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"BL99 kernel: dtype {dtype}: float32 or float64")
    tensors = [named[k] for k in INPUTS] + list(qsno) + list(qice) + \
        list(Iswabs)
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.dtype != dtype or \
                t.device != dev:
            raise ValueError("BL99 kernel: every input a tensor of one "
                             f"dtype on one device, got {t!r:.60}")
    shape = _broadcast_shape([t.shape for t in tensors])
    N = int(np.prod(shape)) if shape else 1
    if N >= 2 ** 31:
        raise ValueError(f"BL99 kernel: {N} columns do not fit int32")
    P = shape[-2] * shape[-1] if len(shape) >= 2 else N
    keep, ptrs, strides = _plane_views(tensors, shape if shape else (1,))
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    consts = kernel_consts(dtype, float(dt), nslyr,
                           tuple(float(s) for s in salin),
                           tuple(float(t) for t in Tm), conduct,
                           float(tv.TSF_ERRMAX))
    nout = len(OUTPUTS) + 2 * (nslyr + nilyr)
    out = torch.empty((nout,) + shape, dtype=dtype, device=dev)
    ws = torch.zeros(2 + nit, dtype=torch.int64, device=dev)
    npass = ws.view(torch.int32)[2]
    f64 = int(dtype == torch.float64)
    cond = CONDUCT[conduct]
    stream = _stream(dev)
    lib = _lib()
    head = (f64, nslyr, nilyr, c_ptrs, c_strides, out.data_ptr(), consts,
            N, P)
    if route == "whole":
        info = device_info(dev.index or 0, bool(f64), nslyr, nilyr)
        blocks = max(1, min(info["sm_count"] * info["blocks_per_sm"],
                            -(-N // info["threads"])))
        _check(lib.bl99_solve(*head, 0, nit, 1, cond, ws.data_ptr(), blocks,
                              stream), f"bl99_solve ({blocks} blocks)")
        whole_launches += 1
    else:
        blocks = max(1, -(-N // THREADS))
        done = 0
        for p in range(nit):
            _check(lib.bl99_solve(*head, p, p + 1, 0, cond, ws.data_ptr(),
                                  blocks, stream), "bl99_solve (a pass)")
            per_pass_launches += 1
            done = p + 1
            err = ws[2 + p:3 + p].view(dtype)[0]
            if not host_read("picard", err > tv.TSF_ERRMAX, mesh):
                break
        _check(lib.bl99_solve(*head, done, done, 0, cond, ws.data_ptr(),
                              blocks, stream), "bl99_solve (the epilogue)")
        per_pass_launches += 1
    del keep

    o = list(out.unbind(0))
    lay = len(OUTPUTS)
    ts = tv.TempSolveOut(Tsno=o[lay:lay + nslyr],
                      Tice=o[lay + nslyr:lay + nslyr + nilyr],
                      **dict(zip(OUTPUTS, o[:lay])))
    return ts, o[lay + nslyr + nilyr:lay + 2 * nslyr + nilyr], \
        o[lay + 2 * nslyr + nilyr:], npass


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream


def _check(err: int, what: str) -> None:
    if err == _SHAPE_ERROR:
        raise ValueError(f"BL99 kernel: {what}: shape not built")
    check(err, what)


def bound_bytes(ncol: int, npass: int, nslyr: int = 1, nilyr: int = 7,
                itemsize: int = 4) -> int:
    """Bytes one solve of `ncol` columns must move in this design (counted
    from the source): every input read and every output written once (the
    epilogue), and per pass the inputs read again plus the iterate read
    and written."""
    n_in = len(INPUTS) + nslyr + 2 * nilyr
    n_out = len(OUTPUTS) + 2 * (nslyr + nilyr)
    n_it = 1 + nslyr + nilyr
    per_pass = n_in + 2 * n_it
    return itemsize * ncol * (n_in + n_out + npass * per_pass)
