"""Boundary / neighbor access on dense global tensors (PyTorch port of
cice_tpu/core/halo.py).

State lives in global `(..., ny, nx)` tensors; `shift(f, dj, di)` returns g
with g[..., j, i] = f[..., j+dj, i+di], applying the physical boundary
condition at the global domain edge:

  - cyclic east-west (or north-south) wrap
  - closed / open edges: ghost value 0 (reference ice_boundary.F90:1179-1183)
  - tripole (U-fold) and tripoleT (T-fold) northern seams: the ghost rows
    are a reversed copy of the top rows, with a pivot that depends on the
    field's location and a sign flip for vector and angle fields
    (reference ice_boundary.F90:7910-9052, ug_implementation.rst:279-380);
    one gather per shift.
"""

from __future__ import annotations

import functools

from dataclasses import dataclass

import torch

from ..constants import (FIELD_LOC_CENTER, FIELD_LOC_EFACE, FIELD_LOC_NFACE,
                         FIELD_TYPE_ANGLE, FIELD_TYPE_SCALAR,
                         FIELD_TYPE_VECTOR)


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
    seam, whose ghost rows `_tripole_ghost_rows` fills for dj > 0; the
    south edge of a tripole grid is a zero ghost."""
    g = _shift_axis(f, di, -1, bc.x_cyclic)
    if dj == 0:
        return g
    if not bc.tripole:
        return _shift_axis(g, dj, -2, bc.y_cyclic)
    out = _shift_axis(g, dj, -2, False)
    if dj > 0:
        out[..., -dj:, :] = _tripole_ghost_rows(g, dj, bc.ns, loc, ftype)
    return out


@functools.lru_cache(maxsize=64)
def _fold_sources(ny: int, nx: int, kind: str, loc: int, n: int,
                  device: torch.device):
    """(rows (n, 1), columns (1, nx)) the fold's n ghost rows gather from,
    made on the device once per shape, fold, location and depth."""
    idx = torch.arange(nx)
    if kind == "tripole":
        pivot = nx - 1 if loc in (FIELD_LOC_CENTER, FIELD_LOC_NFACE) \
            else nx - 2
        on_fold = loc not in (FIELD_LOC_CENTER, FIELD_LOC_EFACE)
        rows = [ny - 1 - k if on_fold else ny - k for k in range(1, n + 1)]
    else:
        pivot = nx if loc in (FIELD_LOC_CENTER, FIELD_LOC_NFACE) else nx - 1
        rows = [ny - 1 - k for k in range(1, n + 1)]
    src_i = (pivot - idx) % nx
    return (torch.tensor(rows)[:, None].to(device),
            src_i[None, :].to(device))


def _tripole_ghost_rows(f: torch.Tensor, n: int, kind: str, loc: int,
                        ftype: int) -> torch.Tensor:
    """Northern ghost rows ny..ny+n-1 for the tripole fold.

    U-fold ('tripole', the fold on the U row j=ny-1): ghost row ny-1+k
    mirrors interior row ny-k for cell and E-face fields and row ny-1-k
    for N-face and NE-corner fields, which lie on the fold line; the mirror
    in i is nx-1-i for centre and N-face fields, nx-2-i (cyclic) for
    NE-corner and E-face fields. T-fold ('tripoleT', the fold on the T row
    j=ny-1): ghost row ny-1+k mirrors row ny-1-k, in i nx-i (centre,
    N face) or nx-1-i (cyclic). Vector and angle fields change sign."""
    src_j, src_i = _fold_sources(f.shape[-2], f.shape[-1], kind, loc, n,
                                 f.device)
    ghost = f[..., src_j, src_i]
    if ftype in (FIELD_TYPE_VECTOR, FIELD_TYPE_ANGLE):
        ghost = -ghost
    return ghost


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
