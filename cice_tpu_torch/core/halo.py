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

On a tile of a grid sharded across the ranks of a `parallel.mesh.Mesh`
the boundary is a `TileBC`: the global BC with the tile's place in the
global grid and the mesh. Each function here then returns exactly this
rank's tile of its global result. A shift keeps its local part and takes
the |dj| rows or |di| columns it lacks from the neighbouring tile, one
`Mesh.exchange` per axis: zero past a non-cyclic global edge, the wrap
across a cyclic one (a copy to itself on a mesh of one rank along that
axis). A diagonal shift goes along x first, then along y across the fresh
columns, so corners carry the diagonal neighbour's data. At a tripole seam
the top row of tiles trades the top rows of the x-shifted field, and each
gathers its ghost rows from the whole-width strip with the global pivot.
Every rank of the mesh must make the same calls in the same order.
"""

from __future__ import annotations

import functools

from dataclasses import dataclass, field

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


@dataclass(frozen=True)
class TileBC(BC):
    """The boundary of one rank's tile of a global (ny, nx) grid sharded
    across the ranks of `mesh`: the global BC (ew, ns), the global shape,
    and the tile's rows y0 .. y0+ly-1 and columns x0 .. x0+lx-1."""
    mesh: object = field(default=None, compare=False, repr=False)
    ny: int = 0
    nx: int = 0
    y0: int = 0
    x0: int = 0
    ly: int = 0
    lx: int = 0

    @property
    def edges(self) -> tuple:
        """(south, north, west, east): whether each side of the tile is an
        edge of the global domain."""
        return (self.y0 == 0, self.y0 + self.ly == self.ny, self.x0 == 0,
                self.x0 + self.lx == self.nx)

    def tile(self, x: torch.Tensor) -> torch.Tensor:
        """This tile of a global (..., ny, nx) array (a view)."""
        return x[..., self.y0:self.y0 + self.ly, self.x0:self.x0 + self.lx]


def tile_mesh(bc: BC):
    """The mesh a tile's boundary trades with (None on a whole grid)."""
    return bc.mesh if isinstance(bc, TileBC) else None


def _edges(bc: BC) -> tuple:
    return bc.edges if isinstance(bc, TileBC) else (True,) * 4


# message tags of the shifts on a tile: one per axis and direction, and
# the tripole strip
_TAG_SHIFT = 16
_TAG_STRIP = 24


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


def _tile_extent(bc: TileBC, axis: int) -> int:
    """The smallest tile extent along `axis` (-1: x, -2: y) on the mesh."""
    from ..parallel.mesh import split
    n, parts = ((bc.nx, bc.mesh.shape[1]) if axis == -1
                else (bc.ny, bc.mesh.shape[0]))
    return min(len(range(n)[split(n, parts, i)]) for i in range(parts))


def _tile_shift_axis(f: torch.Tensor, n: int, axis: int, bc: TileBC,
                     cyclic: bool) -> torch.Tensor:
    """This tile of the global `_shift_axis`: the tile's own values moved
    by n, and the |n| slices beyond its side from the neighbouring tile
    (zero past a non-cyclic global edge)."""
    if n == 0:
        return f
    m = abs(n)
    if m > _tile_extent(bc, axis):
        raise ValueError(f"a shift by {n} along axis {axis} needs tiles of "
                         f"at least {m} cells: {bc.ny}x{bc.nx} on a "
                         f"{bc.mesh.shape[0]}x{bc.mesh.shape[1]} mesh")
    mesh = bc.mesh
    L = f.shape[axis]
    d = (0, 1) if axis == -1 else (1, 0)
    up = mesh.neighbour(*d, y_cyclic=cyclic, x_cyclic=cyclic)
    down = mesh.neighbour(-d[0], -d[1], y_cyclic=cyclic, x_cyclic=cyclic)
    # n > 0 takes the first m slices of the tile above and gives its own
    # first m to the tile below; n < 0 the last m, the other way
    src, dst = (up, down) if n > 0 else (down, up)
    out = f.narrow(axis, 0, m) if n > 0 else f.narrow(axis, L - m, m)
    size = list(f.shape)
    size[axis] = m
    halo = f.new_empty(size)
    tag = _TAG_SHIFT + (n > 0) + 2 * (axis == -1)
    mesh.exchange([(dst, out, tag)] if dst is not None else [],
                  [(src, halo, tag)] if src is not None else [])
    if src is None:
        halo.zero_()
    keep = f.narrow(axis, m, L - m) if n > 0 else f.narrow(axis, 0, L - m)
    return torch.cat([keep, halo] if n > 0 else [halo, keep], dim=axis)


def _tile_ghost_rows(g: torch.Tensor, n: int, bc: TileBC, loc: int,
                     ftype: int):
    """The tripole ghost rows of a tile of the top row (None elsewhere):
    the tiles of the top row trade the top n+1 rows of `g`, and each
    gathers from the whole-width strip with the global pivot."""
    mesh = bc.mesh
    py, px = mesh.shape
    if not bc.edges[1]:
        return None
    if n + 1 > bc.ly:
        raise ValueError(f"a tripole shift by {n} needs tiles of at least "
                         f"{n + 1} rows")
    strip = g[..., bc.ly - n - 1:, :].contiguous()
    peers = [int(r) for r in mesh.ranks[py - 1]]
    parts = []
    for ix in range(px):
        _, sx = mesh.tile_slices(bc.ny, bc.nx, (py - 1, ix))
        parts.append(strip.new_empty(strip.shape[:-1] +
                                     (sx.stop - sx.start,)))
    mesh.exchange([(p, strip, _TAG_STRIP) for p in peers],
                  [(p, t, _TAG_STRIP) for p, t in zip(peers, parts)])
    whole = torch.cat(parts, dim=-1)            # global rows ny-1-n .. ny-1
    src_j, src_i = _fold_sources(n + 1, bc.nx, bc.ns, loc, n, g.device)
    ghost = whole[..., src_j, src_i[:, bc.x0:bc.x0 + bc.lx]]
    if ftype in (FIELD_TYPE_VECTOR, FIELD_TYPE_ANGLE):
        ghost = -ghost
    return ghost


def _tile_shift(f: torch.Tensor, dj: int, di: int, bc: TileBC, loc: int,
                ftype: int) -> torch.Tensor:
    g = _tile_shift_axis(f, di, -1, bc, bc.x_cyclic)
    if dj == 0:
        return g
    if not bc.tripole:
        return _tile_shift_axis(g, dj, -2, bc, bc.y_cyclic)
    out = _tile_shift_axis(g, dj, -2, bc, False)
    if dj > 0:
        ghost = _tile_ghost_rows(g, dj, bc, loc, ftype)
        if ghost is not None:
            out[..., -dj:, :] = ghost
    return out


def shift(f: torch.Tensor, dj: int = 0, di: int = 0, *, bc: BC,
          loc: int = FIELD_LOC_CENTER,
          ftype: int = FIELD_TYPE_SCALAR) -> torch.Tensor:
    """g[..., j, i] = f[..., j+dj, i+di] with global BCs applied.

    The last two axes are (y, x). `loc`/`ftype` only matter at a tripole
    seam, whose ghost rows `_tripole_ghost_rows` fills for dj > 0; the
    south edge of a tripole grid is a zero ghost. On a tile (`TileBC`)
    the tile of the global result."""
    if isinstance(bc, TileBC):
        return _tile_shift(f, dj, di, bc, loc, ftype)
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
    extrapolation of the two interior neighbors. Returns a new tensor. On
    a tile only the sides that are global edges change (tiles of at least
    3 cells: the two neighbours are the tile's own)."""
    f = f.clone()
    south, north, west, east = _edges(bc)
    if not bc.x_cyclic:
        if west:
            f[..., :, 0] = 2.0 * f[..., :, 1] - f[..., :, 2]
        if east:
            f[..., :, -1] = 2.0 * f[..., :, -2] - f[..., :, -3]
    if not bc.y_cyclic and not bc.tripole:
        if south:
            f[..., 0, :] = 2.0 * f[..., 1, :] - f[..., 2, :]
        if north:
            f[..., -1, :] = 2.0 * f[..., -2, :] - f[..., -3, :]
    return f


def apply_closed_mask(f: torch.Tensor, bc: BC,
                      nrows: int = 1) -> torch.Tensor:
    """Zero out nrows at closed domain edges (reference rectgrid land
    ring for ew/ns_boundary_type='closed'). Returns a new tensor. On a
    tile only the sides that are global edges change."""
    f = f.clone()
    south, north, west, east = _edges(bc)
    if bc.ew == "closed":
        if west:
            f[..., :, :nrows] = 0
        if east:
            f[..., :, -nrows:] = 0
    if bc.ns == "closed":
        if south:
            f[..., :nrows, :] = 0
        if north:
            f[..., -nrows:, :] = 0
    return f
