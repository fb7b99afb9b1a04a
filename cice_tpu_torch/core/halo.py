"""Boundary / neighbor access on dense global tensors (PyTorch port of
cice_tpu/core/halo.py).

State lives in global `(..., ny, nx)` tensors; `shift(f, dj, di)` returns g
with g[..., j, i] = f[..., j+dj, i+di], applying the physical boundary
condition at the global domain edge:

  - cyclic east-west (or north-south) wrap
  - closed / open edges: ghost value 0 (reference ice_boundary.F90:1179-1183)

The tripole and tripoleT northern seams are not ported yet (ROADMAP:
tripole and y-cyclic boundaries): `shift` raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..constants import FIELD_LOC_CENTER, FIELD_TYPE_SCALAR


@dataclass(frozen=True)
class BC:
    """Global-domain boundary conditions (grid_nml ew/ns_boundary_type)."""
    ew: str = "cyclic"    # 'cyclic' | 'closed' | 'open'
    ns: str = "open"      # 'open' | 'closed' | 'cyclic' | 'tripole' | 'tripoleT'

    @property
    def x_cyclic(self) -> bool:
        return self.ew == "cyclic"

    @property
    def y_cyclic(self) -> bool:
        return self.ns == "cyclic"

    @property
    def tripole(self) -> bool:
        return self.ns in ("tripole", "tripoleT")


def _shift_axis(f: torch.Tensor, n: int, axis: int,
                cyclic: bool) -> torch.Tensor:
    """g[k] = f[k+n] along `axis`; zero ghost unless cyclic."""
    if n == 0:
        return f
    if cyclic:
        return torch.roll(f, -n, dims=axis)
    L = f.shape[axis]
    g = torch.zeros_like(f)
    if abs(n) >= L:
        return g
    if n > 0:
        g.narrow(axis, 0, L - n).copy_(f.narrow(axis, n, L - n))
    else:
        g.narrow(axis, -n, L + n).copy_(f.narrow(axis, 0, L + n))
    return g


def shift(f: torch.Tensor, dj: int = 0, di: int = 0, *, bc: BC,
          loc: int = FIELD_LOC_CENTER,
          ftype: int = FIELD_TYPE_SCALAR) -> torch.Tensor:
    """g[..., j, i] = f[..., j+dj, i+di] with global BCs applied.

    The last two axes are (y, x). `loc`/`ftype` only matter at a tripole
    seam, which is not ported yet."""
    if bc.tripole:
        raise NotImplementedError(
            "tripole/tripoleT boundaries are not ported yet "
            "(ROADMAP: tripole and y-cyclic boundaries)")
    g = _shift_axis(f, di, -1, bc.x_cyclic)
    if dj == 0:
        return g
    return _shift_axis(g, dj, -2, bc.y_cyclic)


def neighbors4(f: torch.Tensor, *, bc: BC, loc: int = FIELD_LOC_CENTER,
               ftype: int = FIELD_TYPE_SCALAR):
    """(north, south, east, west) neighbor values of f."""
    return (shift(f, 1, 0, bc=bc, loc=loc, ftype=ftype),
            shift(f, -1, 0, bc=bc, loc=loc, ftype=ftype),
            shift(f, 0, 1, bc=bc, loc=loc, ftype=ftype),
            shift(f, 0, -1, bc=bc, loc=loc, ftype=ftype))


def extrapolate_edges(f: torch.Tensor, bc: BC) -> torch.Tensor:
    """ice_HaloExtrapolate (serial/ice_boundary.F90:9056): overwrite the
    outermost row/column along each non-cyclic axis with the linear
    extrapolation of the two interior neighbors. Returns a new tensor."""
    f = f.clone()
    if not bc.x_cyclic:
        f[..., :, 0] = 2.0 * f[..., :, 1] - f[..., :, 2]
        f[..., :, -1] = 2.0 * f[..., :, -2] - f[..., :, -3]
    if not bc.y_cyclic and not bc.tripole:
        f[..., 0, :] = 2.0 * f[..., 1, :] - f[..., 2, :]
        f[..., -1, :] = 2.0 * f[..., -2, :] - f[..., -3, :]
    return f


def apply_closed_mask(f: torch.Tensor, bc: BC,
                      nrows: int = 1) -> torch.Tensor:
    """Zero out nrows at closed domain edges (reference rectgrid land
    ring for ew/ns_boundary_type='closed'). Returns a new tensor."""
    f = f.clone()
    if bc.ew == "closed":
        f[..., :, :nrows] = 0
        f[..., :, -nrows:] = 0
    if bc.ns == "closed":
        f[..., :nrows, :] = 0
        f[..., -nrows:, :] = 0
    return f
