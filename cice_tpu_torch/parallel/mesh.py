"""The rank grid of a run across ranks (PyTorch port of
cice_tpu/parallel/mesh.py; reference comm/mpi: ice_boundary's halo
messages, ice_distribution's block->rank map, gather/scatter).

A `Mesh` lays the ranks of an initialised torch.distributed process group
(the caller initialises it: `torchrun`, or a spawner of its own) on a
(py, px) grid: rows of tiles split the global (ny, nx) arrays in y,
columns in x. It gives each rank its tile, its neighbours and its x-mirror
partner (the tripole fold's), and moves data between them:

- `exchange(sends, recvs)`: point-to-point messages, one
  `batch_isend_irecv`; a message a rank sends itself is a copy;
- `all_gather_tiles`, `all_reduce`, `all_gather`, `all_sum`, `barrier`:
  the collectives of the wide-halo EVP, of `core.reductions` and of the
  VP solver's inner products (`all_sum` adds the ranks' parts in rank
  order, so every rank reads the same bits).

gloo moves CPU tensors only, so under gloo every CUDA tensor is copied to
the host on its way out and back on its way in (the exchange's through
pinned buffers it keeps). That staging is explicit, and every call counts
it; the arithmetic stays on the card. Under NCCL the same calls move CUDA
tensors directly. The counters, split so that they add up:

- `staged_bytes`, `staged_seconds`: the copies between card and host
  (exchanges and collectives alike);
- `wait_seconds`: before staging, the wait for the card's queued work
  (on the wide EVP, the K1 launches since the last message);
- `wire_seconds`: the host's time in the process group's calls, the
  wait for the peers included;
- `exchanges`, `collectives`: the calls of each kind made.

With no process group a Mesh is a 1x1 grid of the one process.

A run with the state sharded across the ranks (model.driver.Model with
`shard=True`) holds on each rank its tile of every (..., ny, nx) array:
`shard_state` tiles a tree of arrays, `gather_state` makes it whole again
on every rank, and `tile_grid` gives a Grid of this rank's tiles whose
boundary (`core.halo.TileBC`) makes every `shift` on it a tile of the
global shift. Tiles may be unequal (`split`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .decomp import auto_decomp, spacecurve_device_order

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def near_square(n: int) -> tuple:
    """(py, px) with py the largest divisor of n not above sqrt(n)."""
    py = int(np.floor(np.sqrt(n)))
    while n % py:
        py -= 1
    return py, n // py


def split(n: int, parts: int, i: int) -> slice:
    """Part i of `parts` of range(n), in pieces of ceil(n / parts) (the
    last one shorter)."""
    t = -(-n // parts)
    return slice(min(i * t, n), min((i + 1) * t, n))


class Mesh:
    """A (py, px) grid of the ranks of `group` (default: the whole world).

    shape: (py, px); else from `grid_shape=(ny, nx)` through
    `decomp.auto_decomp`; else the near-square split. `curve_order` lays
    the ranks along `decomp.spacecurve_device_order`."""

    def __init__(self, shape: Optional[Sequence[int]] = None, *,
                 grid_shape: Optional[Sequence[int]] = None,
                 curve_order: bool = False, group=None):
        if dist.is_available() and dist.is_initialized():
            group = group if group is not None else dist.group.WORLD
            self.group_ranks = list(dist.get_process_group_ranks(group))
            self.rank = dist.get_rank()
            self.backend = str(dist.get_backend(group))
        else:
            group, self.group_ranks, self.rank, self.backend = \
                None, [0], 0, None
        self.group = group
        n = len(self.group_ranks)
        if shape is None:
            shape = (auto_decomp(grid_shape[1], grid_shape[0], n)[0]
                     if grid_shape is not None else near_square(n))
        py, px = (int(v) for v in shape)
        if py * px != n:
            raise ValueError(f"a {py}x{px} mesh needs {py * px} ranks; the "
                             f"group has {n}")
        order = (spacecurve_device_order(py, px) if curve_order
                 else np.arange(n))
        #: ranks[iy, ix]: the global rank that holds tile (iy, ix)
        self.ranks = np.asarray(self.group_ranks)[order].reshape(py, px)
        where = np.argwhere(self.ranks == self.rank)
        if not len(where):
            raise ValueError(f"rank {self.rank} is not in the mesh's group")
        self.coords = (int(where[0][0]), int(where[0][1]))
        self.exchanges = 0
        self.collectives = 0
        self.staged_bytes = 0
        self.staged_seconds = 0.0
        self.wait_seconds = 0.0
        self.wire_seconds = 0.0
        self._pinned: dict = {}

    # -- layout -------------------------------------------------------------
    @property
    def shape(self) -> tuple:
        return tuple(self.ranks.shape)

    @property
    def size(self) -> int:
        return self.ranks.size

    def coords_of(self, rank: int) -> tuple:
        iy, ix = np.argwhere(self.ranks == rank)[0]
        return int(iy), int(ix)

    def tile_slices(self, ny: int, nx: int, coords=None) -> tuple:
        """(y slice, x slice) of the tile at `coords` (default: this
        rank's) in a global (ny, nx) array."""
        iy, ix = self.coords if coords is None else coords
        py, px = self.shape
        return split(ny, py, iy), split(nx, px, ix)

    def tile(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's tile of a global (..., ny, nx) array (a view)."""
        sy, sx = self.tile_slices(*x.shape[-2:])
        return x[..., sy, sx]

    def neighbour(self, dy: int, dx: int, *, y_cyclic: bool = False,
                  x_cyclic: bool = False) -> Optional[int]:
        """The rank of the tile (dy, dx) away, wrapped along a cyclic axis;
        None past a non-cyclic edge."""
        py, px = self.shape
        iy, ix = self.coords[0] + dy, self.coords[1] + dx
        if not 0 <= iy < py:
            if not y_cyclic:
                return None
            iy %= py
        if not 0 <= ix < px:
            if not x_cyclic:
                return None
            ix %= px
        return int(self.ranks[iy, ix])

    def mirror(self) -> int:
        """The rank of the x-mirrored tile in this rank's row (the tripole
        fold's partner)."""
        iy, ix = self.coords
        return int(self.ranks[iy, self.shape[1] - 1 - ix])

    # -- staging (gloo carries CPU tensors only) -----------------------------
    def _stages(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _settle(self, device) -> None:
        """Wait for the card's queued work, so that the staging clock that
        follows times the copies alone."""
        t0 = time.perf_counter()
        torch.cuda.synchronize(device)
        self.wait_seconds += time.perf_counter() - t0

    def _host(self, key, t: torch.Tensor) -> torch.Tensor:
        buf = self._pinned.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    # -- point to point -----------------------------------------------------
    def exchange(self, sends, recvs) -> None:
        """Send and receive in one batch. `sends`: (peer, tensor, tag);
        `recvs`: (peer, tensor, tag), each tensor filled in place with the
        message of that tag from that peer. Messages between two ranks
        are matched by tag, and in the order they are listed."""
        self.exchanges += 1
        sends, recvs = list(sends), list(recvs)
        cards = {t.device for peer, t, _ in sends + recvs
                 if peer != self.rank and self._stages(t)}
        for device in cards:
            self._settle(device)
        t0 = time.perf_counter()
        staged = 0
        local, ops, keep, after = {}, [], [], []
        for peer, t, tag in sends:
            if peer == self.rank:
                local[tag] = t.clone()
                continue
            if self._stages(t):
                wire = self._host(("send", peer, tag), t)
                wire.copy_(t)
                staged += t.numel() * t.element_size()
            else:
                wire = t.contiguous()
            keep.append(wire)
            ops.append(dist.P2POp(dist.isend, wire, peer, self.group, tag))
        for peer, t, tag in recvs:
            if peer == self.rank:
                t.copy_(local[tag])
                continue
            if self._stages(t):
                wire = self._host(("recv", peer, tag), t)
                staged += t.numel() * t.element_size()
            else:
                wire = t if t.is_contiguous() else torch.empty_like(
                    t, memory_format=torch.contiguous_format)
            if wire is not t:
                after.append((t, wire))
            ops.append(dist.P2POp(dist.irecv, wire, peer, self.group, tag))
        t_out = time.perf_counter() - t0
        if ops:
            tw = time.perf_counter()
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            self.wire_seconds += time.perf_counter() - tw
        t1 = time.perf_counter()
        for t, wire in after:
            t.copy_(wire)
        if staged:
            self.staged_bytes += staged
            self.staged_seconds += t_out + time.perf_counter() - t1

    # -- collectives ----------------------------------------------------------
    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of `t` to put on the wire: on the host under gloo."""
        if not self._stages(t):
            return t.clone(memory_format=torch.contiguous_format)
        self._settle(t.device)
        t0 = time.perf_counter()
        wire = t.cpu()
        self.staged_bytes += wire.numel() * wire.element_size()
        self.staged_seconds += time.perf_counter() - t0
        return wire

    def _in(self, wire: torch.Tensor, device) -> torch.Tensor:
        """A message back on `device` (a copy from the host under gloo)."""
        if wire.device == torch.device(device):
            return wire
        t0 = time.perf_counter()
        out = wire.to(device)
        self.staged_bytes += wire.numel() * wire.element_size()
        self.staged_seconds += time.perf_counter() - t0
        return out

    def _wire(self, call, *args, **kw) -> None:
        self.collectives += 1
        t0 = time.perf_counter()
        call(*args, group=self.group, **kw)
        self.wire_seconds += time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The reduction ('sum', 'max' or 'min') of `t` over the mesh's
        ranks, as a new tensor on `t`'s device."""
        if self.size == 1:
            return t.clone()
        wire = self._out(t)
        self._wire(dist.all_reduce, wire, _OPS[op])
        return self._in(wire, t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """`t` of every rank, stacked in group order on `t`'s device."""
        if self.size == 1:
            return t[None].clone()
        wire = self._out(t)
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        self._wire(dist.all_gather, parts, wire)
        return self._in(torch.stack(parts), t.device)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the mesh's ranks as parts[0] + parts[1] +
        ... in group order, whatever order the process group adds in, so
        every rank reads the same bits; a new tensor on `t`'s device. Under
        gloo the parts are added on the host, where they arrive."""
        if self.size == 1:
            return t.clone()
        wire = self._out(t)
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        self._wire(dist.all_gather, parts, wire)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return self._in(total, t.device)

    def all_gather_tiles(self, tile: torch.Tensor, ny: int,
                         nx: int) -> torch.Tensor:
        """The global (..., ny, nx) array whose tiles are the ranks'
        `tile`s. Unequal tiles travel padded to the largest."""
        sy, sx = self.tile_slices(ny, nx)
        if tuple(tile.shape[-2:]) != (sy.stop - sy.start, sx.stop - sx.start):
            raise ValueError(f"tile {tuple(tile.shape)} is not this rank's "
                             f"tile of a {ny}x{nx} grid")
        if self.size == 1:
            return tile.clone()
        ty, tx = -(-ny // self.shape[0]), -(-nx // self.shape[1])
        wire = tile.new_zeros(tile.shape[:-2] + (ty, tx))
        wire[..., :tile.shape[-2], :tile.shape[-1]] = tile
        parts = self.all_gather(wire)
        out = torch.empty(tile.shape[:-2] + (ny, nx), dtype=tile.dtype,
                          device=tile.device)
        for r, part in zip(self.group_ranks, parts):
            sy, sx = self.tile_slices(ny, nx, self.coords_of(r))
            out[..., sy, sx] = part[..., :sy.stop - sy.start,
                                    :sx.stop - sx.start]
        return out

    def barrier(self) -> None:
        if self.size > 1:
            self.collectives += 1
            dist.barrier(group=self.group)

    # -- sharded state ------------------------------------------------------
    def shard_state(self, tree, shape: Optional[Sequence[int]] = None):
        """`tree` (a dataclass, dict, list or tuple of tensors, nested) with
        each leaf of two or more dimensions replaced by a contiguous copy of
        this rank's tile, or with `shape` = (ny, nx) each leaf whose last
        two dimensions are (ny, nx); other leaves stay as they are
        (replicated), as `cice_tpu.parallel.mesh.shard_state` lays them."""
        def cut(x):
            if x.ndim < 2 or (shape is not None and
                              tuple(x.shape[-2:]) != tuple(shape)):
                return x
            return self.tile(x).clone(memory_format=torch.contiguous_format)
        return map_tree(cut, tree)

    def gather_state(self, tree, shape: Sequence[int]):
        """The inverse of `shard_state` for a global (ny, nx) = `shape`:
        each leaf whose last two dimensions are this rank's tile becomes
        the whole array, on every rank."""
        ny, nx = shape
        sy, sx = self.tile_slices(ny, nx)
        tshape = (sy.stop - sy.start, sx.stop - sx.start)

        def whole(x):
            if x.ndim < 2 or tuple(x.shape[-2:]) != tshape:
                return x
            return self.all_gather_tiles(x, ny, nx)
        return map_tree(whole, tree)

    def tile_bc(self, bc, shape: Sequence[int]):
        """The `core.halo.TileBC` of this rank's tile of a global (ny, nx)
        = `shape` grid with boundary `bc`."""
        from ..core.halo import TileBC
        ny, nx = shape
        sy, sx = self.tile_slices(ny, nx)
        return TileBC(ew=bc.ew, ns=bc.ns, mesh=self, ny=ny, nx=nx,
                      y0=sy.start, x0=sx.start, ly=sy.stop - sy.start,
                      lx=sx.stop - sx.start)

    def tile_grid(self, grid):
        """A Grid of this rank's tiles of `grid` (whole): every metric and
        mask tiled, the boundary a `core.halo.TileBC`."""
        from ..core.grid import tile_grid
        return tile_grid(grid, self)


def map_tree(fn, tree):
    """`tree` with fn applied to every tensor leaf: dataclasses (rebuilt
    with `dataclasses.replace`), dicts, lists and tuples are walked; other
    leaves stay."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tree(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(map_tree(fn, v) for v in tree)
    if isinstance(tree, tuple):                 # a NamedTuple
        return type(tree)(*(map_tree(fn, v) for v in tree))
    return tree
