"""Global reductions with the reference's reproducibility options (PyTorch
port of cice_tpu/core/reductions.py; reference comm/{mpi,serial}/
ice_global_reductions.F90 and ice_reprosum.F90).

  bfbflag = 'off'      plain sum
            'lsum4'    float32 accumulation (the reference's low-precision
                       local sums, ice_global_reductions.F90:99-750)
            'lsum8'    float64 accumulation
            'lsum16'   double-double accumulation in float64 (the
                       reference's REAL*16 local sums: ~32 digits)
            'ddpdd'    compensated summation in the field's dtype
            'reprosum' integer fixed-point accumulation: exact, so the same
                       bits for any order or decomposition of the summands
                       (ice_reprosum.F90:262)

Every sum runs on the tensor's device. 'lsum16' and 'ddpdd' are pairwise
trees with TwoSum at every level carrying the rounding errors beside the
sums (the JAX package scans rows serially, which here would be a chain of
dependent launches); they are held to the JAX tests' accuracy, not to
JAX's bits. 'reprosum' takes the JAX package's fixed-point window.

With `mesh` (parallel.mesh.Mesh), `field` (and `weight`, `mask`) are this
rank's tile: each rank reduces its tile, then the ranks combine. For
'reprosum' they take the largest magnitude first (the window), then sum
the integers, so the result is bit-identical on any mesh; 'lsum16' and
'ddpdd' combine the ranks' (sum, error) pairs in the same TwoSum tree;
the others add the ranks' partial sums.

A step on a sharded state makes host decisions on data (a Picard exit, a
ridging pass, a category move): every rank must take the same branch, or
the shifts of a branch one rank skips leave its peers waiting.
`agreed(x, mesh)` is `x` reduced over the mesh's ranks, read the same on
each. `host_read` is the one way a step reads the device on the host: it
agrees the value, converts it, counts the read by site and, while a
profiler runs, spans the wait (utils/timers.py).
"""

from __future__ import annotations

import torch

from ..utils.timers import count_sync, span

BFBFLAGS = ("off", "lsum4", "lsum8", "lsum16", "ddpdd", "reprosum")


def _two_sum(a, b):
    """s, e with s = fl(a + b) and a + b = s + e exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _dd_tree(hi: torch.Tensor, lo: torch.Tensor):
    """(sum, error) of sum(hi) + sum(lo) for two flat tensors, by a
    pairwise TwoSum tree whose errors join the low parts at every level."""
    if not hi.numel():
        hi, lo = hi.new_zeros(1), lo.new_zeros(1)
    while hi.numel() > 1:
        if hi.numel() % 2:
            z = hi.new_zeros(1)
            hi, lo = torch.cat([hi, z]), torch.cat([lo, z])
        s, e = _two_sum(hi[0::2], hi[1::2])
        hi, lo = s, lo[0::2] + lo[1::2] + e
    return hi[0], lo[0]


def _fixedpoint_window(absmax: torch.Tensor, frac_bits: int = 32):
    """The power of two that scales the largest magnitude to about
    2**frac_bits: 2 ** (frac_bits - ceil(log2(absmax))), 1 for zero. The
    power is assembled from its exponent bits, exactly on any device."""
    f64 = absmax.dtype == torch.float64
    e = torch.ceil(torch.log2(absmax + 1e-300))
    if f64:
        n = torch.clamp(frac_bits - e, -1022, 1023).to(torch.int64)
        scale = ((n + 1023) << 52).view(torch.float64)
    else:
        n = torch.clamp(frac_bits - e, -126, 127).to(torch.int32)
        scale = ((n + 127) << 23).view(torch.float32)
    return torch.where(absmax > 0, scale, torch.ones_like(scale))


def global_sum(field: torch.Tensor, *, weight=None, mask=None,
               bfbflag: str = "off", mesh=None) -> torch.Tensor:
    """Weighted, masked sum over the global grid (a 0-d tensor in the
    field's dtype)."""
    x = field
    if weight is not None:
        x = x * weight
    if mask is not None:
        x = torch.where(mask, x, torch.zeros_like(x))
    combine = (lambda t: t) if mesh is None else mesh.all_reduce
    if bfbflag == "off":
        return combine(x.sum())
    if bfbflag == "lsum4":
        return combine(x.to(torch.float32).sum()).to(field.dtype)
    if bfbflag == "lsum8":
        return combine(x.to(torch.float64).sum()).to(field.dtype)
    if bfbflag in ("lsum16", "ddpdd"):
        xd = x.to(torch.float64) if bfbflag == "lsum16" else x
        flat = xd.reshape(-1)
        hi, lo = _dd_tree(flat, torch.zeros_like(flat))
        if mesh is not None:
            # the ranks' (sum, error) pairs through the same tree
            parts = mesh.all_gather(torch.stack([hi, lo]))
            hi, lo = _dd_tree(parts[:, 0], parts[:, 1])
        return (hi + lo).to(field.dtype)
    if bfbflag == "reprosum":
        return _fixedpoint_sum(x, mesh).to(field.dtype)
    raise ValueError(f"unknown bfbflag {bfbflag!r}; one of {BFBFLAGS}")


def _fixedpoint_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Exact layout-invariant sum (the spirit of Worley's reprosum,
    ice_reprosum.F90:62): scale to int64 fixed point and sum; integers
    commute, so any order or decomposition gives the same bits while the
    values fit the window, which the largest magnitude sets."""
    absmax = x.abs().max() if x.numel() else x.new_zeros(())
    if mesh is not None:
        absmax = mesh.all_reduce(absmax, "max")
    scale = _fixedpoint_window(absmax)
    xs = x.to(torch.float64) if x.dtype == torch.float64 else \
        x.to(torch.float32)
    total = torch.round(xs * scale).to(torch.int64).sum()
    if mesh is not None:
        total = mesh.all_reduce(total, "sum")
    return total.to(scale.dtype) / scale


def global_maxval(field: torch.Tensor, mask=None, *, mesh=None):
    x = field
    if mask is not None:
        x = torch.where(mask, x, torch.full_like(x, -torch.inf))
    m = x.max()
    return m if mesh is None else mesh.all_reduce(m, "max")


def global_minval(field: torch.Tensor, mask=None, *, mesh=None):
    x = field
    if mask is not None:
        x = torch.where(mask, x, torch.full_like(x, torch.inf))
    m = x.min()
    return m if mesh is None else mesh.all_reduce(m, "min")


def agreed(x: torch.Tensor, mesh=None, op: str = "max") -> torch.Tensor:
    """`x`, a tensor a host decision reads on a rank's tiles, reduced
    ('max', 'min' or 'sum'; a bool by any) over the ranks of `mesh`, so
    that every rank takes the same branch; `x` itself without a mesh."""
    if mesh is None or mesh.size == 1:
        return x
    if x.dtype == torch.bool:
        return mesh.all_reduce(x.to(torch.uint8), "max").bool()
    return mesh.all_reduce(x, op)


def host_read(site: str, x, mesh=None, op: str = "max"):
    """The Python value (`.item()`, or `.tolist()` for more than one
    element) of `agreed(x, mesh, op)`: a blocking read of the device,
    counted at `site` and spanned "sync:<site>" while a profiler runs. A
    value that is not a tensor is returned as it is, uncounted."""
    if not isinstance(x, torch.Tensor):
        return x
    x = agreed(x, mesh, op)
    count_sync(site)
    with span("sync:" + site):
        return x.item() if x.dim() == 0 else x.tolist()


def host_wait(site: str, device: torch.device) -> None:
    """Wait for everything queued on a CUDA `device`, counted and spanned
    at `site` as `host_read` does; nothing on another device."""
    if device.type != "cuda":
        return
    count_sync(site)
    with span("sync:" + site):
        torch.cuda.synchronize(device)
