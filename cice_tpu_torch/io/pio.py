"""Sharded files: one file per rank's tile (PyTorch port of
cice_tpu/io/pio.py, the io_pio2 analogue).

The reference's PIO2 backend (cicecore/cicedyn/infrastructure/io/io_pio2/,
`ice_pio.F90:591`) lets each rank write its own blocks instead of
gathering the globe on rank 0. Here each rank writes its tile of an array
as one .npy file, with a JSON manifest of the global shape, the dtype and
each shard's index slices. The layout is the JAX package's, so either
package reads what the other wrote, on any mesh:

    <name>.p<rank>s<k>.npy          a shard (k counts a rank's shards)
    <name>.manifest.json            the first rank's manifest
    <name>.manifest.p<rank>.json    the manifest of every other rank

Without a mesh an array is one shard. With a mesh (parallel.mesh.Mesh)
each rank writes its tile of every array of two or more dimensions; the
mesh's first rank (rank 0 of the whole world, or the first of a mesh's
group) alone writes a smaller one. A restart (`write_restart_sharded`) is a
directory `<prefix>.<timestamp>.pio/` of the state's leaves (`leaf_<i>`,
numbered as io/restart.py numbers them) and `meta.json` with the calendar,
named by the pointer file.

The reader takes every manifest of a field and reassembles the whole
array, so a restart written on one mesh shape reads on any other. A state
sharded across the ranks writes each rank's tiles as they are
(`tiles_of=`, the global shape).

Order on the disk: a manifest is the follow-on of its shard (written after
the shard is in place, inline or by the background writer's worker), and
`meta.json`'s job carries the pointer as its follow-on; the writer lands
follow-ons in submission order, so the pointer never names a restart whose
shards or manifests are not on the disk. (The JAX package writes manifests
and pointer at once while the shards are still queued, pio.py:80-82,
130-134.) Across ranks, every rank flushes its writer, the ranks meet at a
barrier, and only then the first rank writes `meta.json` and the pointer.
"""

from __future__ import annotations

import io
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..calendar import Calendar
from ..model.state import State, state_from_leaves, state_leaves
from .async_writer import write_bytes


def _index_to_json(idx, ndim: int) -> list:
    """A shard's index (slices) as [[start, stop], ...] over every axis."""
    full = tuple(idx) + (slice(None),) * (ndim - len(idx))
    return [[sl.start, sl.stop] for sl in full]


def _index_from_json(spec) -> tuple:
    return tuple(slice(a, b) for a, b in spec)


def _rank(mesh) -> Tuple[int, int, bool]:
    """(rank, ranks, whether this rank leads: the mesh's first)."""
    if mesh is None:
        return 0, 1, True
    return mesh.rank, mesh.size, mesh.rank == mesh.group_ranks[0]


def write_field_sharded(dirpath: str, name: str, arr: torch.Tensor,
                        writer=None, mesh=None,
                        tiles_of=None) -> Optional[dict]:
    """Write this rank's shard of `arr` and its manifest; returns the
    manifest (None on a rank that holds no shard of it). With `writer`
    (io.async_writer.AsyncWriter) the shard is queued and the manifest is
    its follow-on. tiles_of: the global (ny, nx) when `arr` is already
    this rank's tile (its last two dimensions)."""
    os.makedirs(dirpath, exist_ok=True)
    rank, nprocs, lead = _rank(mesh)
    shape = tuple(arr.shape)
    tiled = (tiles_of is not None and arr.ndim >= 2 and
             shape[-2:] == tuple(s.stop - s.start for s in
                                 mesh.tile_slices(*tiles_of)))
    if tiled:
        shape = shape[:-2] + tuple(tiles_of)
    if mesh is not None and arr.ndim >= 2:
        sy, sx = mesh.tile_slices(*shape[-2:])
        index = (slice(None),) * (arr.ndim - 2) + (sy, sx)
    elif lead:
        index = ()
    else:
        return None
    shard = arr if tiled or not index else arr[index]
    data = shard.detach().cpu().numpy()
    fname = f"{name}.p{rank}s000.npy"
    manifest = {"shape": list(shape), "dtype": str(data.dtype),
                "shards": [{"file": fname,
                            "index": _index_to_json(index, arr.ndim),
                            "device": str(arr.device)}],
                "nprocs": nprocs}
    mname = (f"{name}.manifest.json" if lead
             else f"{name}.manifest.p{rank}.json")
    buf = io.BytesIO()
    np.save(buf, data)
    write_bytes(os.path.join(dirpath, fname), buf.getvalue(), writer,
                (os.path.join(dirpath, mname), json.dumps(manifest)))
    return manifest


def _read_array(dirpath: str, name: str) -> np.ndarray:
    parts = sorted(p for p in os.listdir(dirpath)
                   if p.startswith(name + ".manifest"))
    if not parts:
        raise FileNotFoundError(f"no manifest for field '{name}' in "
                                f"{dirpath}")
    shards, shape, dtype = [], None, None
    for p in parts:
        with open(os.path.join(dirpath, p)) as f:
            man = json.load(f)
        shape, dtype = tuple(man["shape"]), np.dtype(man["dtype"])
        shards.extend(man["shards"])
    out = np.empty(shape, dtype)
    seen = np.zeros(shape, bool)
    for s in shards:
        idx = _index_from_json(s["index"])
        out[idx] = np.load(os.path.join(dirpath, s["file"]))
        seen[idx] = True
    if not seen.all():
        raise IOError(f"field '{name}': the shard files do not cover the "
                      "array")
    return out


def read_field_sharded(dirpath: str, name: str,
                       device="cpu") -> torch.Tensor:
    """The whole array of a sharded field, from every manifest of it (any
    mesh shape, either package), on `device`."""
    return torch.from_numpy(_read_array(dirpath, name)).to(device)


def write_restart_sharded(dirpath: str, state: State, calendar: Calendar,
                          pointer_file: Optional[str] = None, *,
                          prefix: str = "iced", writer=None, mesh=None,
                          extra: Optional[dict] = None,
                          tiles_of=None) -> str:
    """PIO-style restart dump: every leaf written shard-wise under
    `<dirpath>/<prefix>.<timestamp>.pio/`, then `meta.json` and the pointer
    (the io/restart.py contract). Returns the directory. tiles_of: the
    global (ny, nx) when `state` is this rank's tiles."""
    ddir = os.path.join(dirpath, f"{prefix}.{calendar.timestamp()}.pio")
    os.makedirs(ddir, exist_ok=True)
    leaves = state_leaves(state)
    for i, leaf in enumerate(leaves):
        write_field_sharded(ddir, f"leaf_{i}", leaf, writer=writer,
                            mesh=mesh, tiles_of=tiles_of)
    meta = dict(year=calendar.year, month=calendar.month, day=calendar.day,
                sec=calendar.sec, istep=calendar.istep,
                calendar_type=calendar.calendar_type,
                year_init=calendar.year_init, nleaves=len(leaves))
    if extra:
        meta.update(extra)
    pointer = None
    if pointer_file:
        os.makedirs(os.path.dirname(pointer_file) or ".", exist_ok=True)
        pointer = (pointer_file, ddir + "\n")
    if mesh is not None and mesh.size > 1:
        if writer is not None and writer.flush():
            raise IOError(f"rank {mesh.rank}: background shard writes "
                          f"of {ddir} failed")
        mesh.barrier()
        writer = None
    if _rank(mesh)[2]:
        write_bytes(os.path.join(ddir, "meta.json"),
                    json.dumps(meta).encode(), writer, pointer)
    return ddir


def read_restart_sharded(path_or_pointer: str,
                         template: State) -> Tuple[State, Calendar]:
    """Load a sharded restart (its directory, or the pointer file naming
    it); every leaf whole, on the template's device in its dtype."""
    path = path_or_pointer
    if not os.path.isdir(path):
        with open(path) as f:
            path = f.read().strip()
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    refs = state_leaves(template)
    if meta["nleaves"] != len(refs):
        raise ValueError(f"{path}: {meta['nleaves']} leaves, the state has "
                         f"{len(refs)}")
    leaves = []
    for i, ref in enumerate(refs):
        arr = _read_array(path, f"leaf_{i}")
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: leaf_{i} has shape {arr.shape}, the "
                             f"state expects {tuple(ref.shape)}")
        leaves.append(torch.from_numpy(arr).to(device=ref.device,
                                               dtype=ref.dtype))
    cal = Calendar(calendar_type=meta["calendar_type"], year=meta["year"],
                   month=meta["month"], day=meta["day"], sec=meta["sec"],
                   istep=meta["istep"], year_init=meta["year_init"])
    return state_from_leaves(template, leaves), cal
