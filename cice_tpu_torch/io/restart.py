"""Restart (checkpoint/resume) — exact-restart contract (PyTorch port of
cice_tpu/io/restart.py; reference ice_restart_driver.F90 `dumpfile`:56,
`restartfile`:281, and the io_binary/io_netcdf `ice_restart` backends).

The prognostic state and the calendar round-trip bit for bit, and a POINTER
FILE names the latest restart (reference `ice.restart_file`). The files
are the JAX package's: leaves `leaf_0 ... leaf_N` in `model.state
.state_leaves` order plus the calendar as JSON metadata, so a restart
written by either package loads into the other.

Formats: 'npz' (numpy .npz, exact), 'cdf1' (netCDF-3 classic through
scipy, with lossless casts for the types it lacks) and 'hdf5' (h5py,
imported at the call). The sharded 'pio' format waits for ROADMAP A8.
A dump may go through the background writer (`writer=`); the pointer then
follows its payload onto the disk.
"""

from __future__ import annotations

import io
import json
import os
from typing import Tuple

import numpy as np
import torch

from ..calendar import Calendar
from ..model.state import State, state_from_leaves, state_leaves
from .async_writer import SnapshotBytesIO, write_bytes

# netCDF-3 classic has no 64-bit-int/bool types (reference io_netcdf restart
# stores logicals as reals, io_netcdf/ice_restart.F90): lossless i1/i4 casts,
# original dtype recorded per variable for the exact round-trip.
_NC3_CAST = {np.dtype(np.bool_): np.dtype(np.int8),
             np.dtype(np.int64): np.dtype(np.int32),
             np.dtype(np.uint8): np.dtype(np.int8),
             np.dtype(np.uint32): np.dtype(np.int32)}

FORMATS = ("npz", "cdf1", "hdf5")


def _write_restart_cdf1(fileobj, arrays: dict, meta: dict) -> None:
    """NetCDF-3 classic restart body (reference io_netcdf/ice_restart.F90
    define/write per field on root; restart_format='cdf1')."""
    from scipy.io import netcdf_file

    with netcdf_file(fileobj, "w") as f:
        f.meta_json = json.dumps(meta).encode()
        dims = {}
        for name, arr in arrays.items():
            scalar = arr.ndim == 0
            if scalar:
                arr = arr.reshape(1)
            vdims = []
            for size in arr.shape:
                if size not in dims:
                    dname = f"d{size}"
                    f.createDimension(dname, size)
                    dims[size] = dname
                vdims.append(dims[size])
            out = arr
            if arr.dtype in _NC3_CAST:
                out = arr.astype(_NC3_CAST[arr.dtype])
            v = f.createVariable(name, out.dtype.str.lstrip("<>=|"),
                                 tuple(vdims))
            v[:] = out
            v.orig_dtype = arr.dtype.str.encode()
            v.orig_scalar = np.array([1 if scalar else 0], np.int32)


def _read_restart_cdf1(path: str):
    from scipy.io import netcdf_file

    arrays = {}
    with netcdf_file(path, "r", mmap=False) as f:
        meta = json.loads(bytes(f.meta_json).decode())
        for name, v in f.variables.items():
            arr = np.asarray(v[:]).astype(np.dtype(v.orig_dtype.decode()))
            if np.any(np.asarray(getattr(v, "orig_scalar", 0))):
                arr = arr.reshape(())
            arrays[name] = arr
    return arrays, meta


def _write_restart_h5(fileobj, arrays: dict, meta: dict) -> None:
    """HDF5 restart body (reference restart_format='hdf5'; io_netcdf
    ice_restart.F90 with nf90_netcdf4). Exact dtype round-trip is native —
    HDF5 stores bools/int64 losslessly (no _NC3_CAST needed)."""
    import h5py

    with h5py.File(fileobj, "w") as f:
        f.attrs["meta_json"] = json.dumps(meta)
        for name, arr in arrays.items():
            f.create_dataset(name, data=arr,
                             **(dict(compression="gzip", compression_opts=1)
                                if arr.ndim else {}))


def _read_restart_h5(path: str):
    import h5py

    arrays = {}
    with h5py.File(path, "r") as f:
        meta = json.loads(f.attrs["meta_json"])
        for name in f:
            arrays[name] = np.asarray(f[name])
    return arrays, meta


_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"


def _is_hdf5(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == _HDF5_MAGIC


def write_restart(dirpath: str, state: State, calendar: Calendar,
                  pointer_file: str | None = None, *, prefix: str = "iced",
                  extra: dict | None = None, fmt: str = "npz",
                  writer=None) -> str:
    """Dump state to `<dirpath>/<prefix>.<timestamp>.{npz,nc}`; update the
    pointer file. Returns the restart's path.

    fmt: 'npz' (exact bytes), 'cdf1' (netCDF-3 classic, the io_netcdf
    ice_restart analogue) or 'hdf5' (netCDF-4/HDF5, deflated, native exact
    dtypes; needs h5py). With `writer` (io.async_writer.AsyncWriter) the
    payload is serialised here and queued; call `writer.flush()` before
    reading it back. The pointer is written only after the payload is on
    disk, inline or by the writer's worker."""
    if fmt == "pio":
        raise NotImplementedError(
            "restart_format='pio' (sharded restarts) is not ported yet "
            "(ROADMAP A8: multi-GPU)")
    if fmt not in FORMATS:
        raise ValueError(f"unknown restart format {fmt!r}; one of {FORMATS}")
    os.makedirs(dirpath, exist_ok=True)
    arrays = {f"leaf_{i}": x.detach().cpu().numpy()
              for i, x in enumerate(state_leaves(state))}
    meta = dict(year=calendar.year, month=calendar.month, day=calendar.day,
                sec=calendar.sec, istep=calendar.istep,
                calendar_type=calendar.calendar_type,
                year_init=calendar.year_init)
    if extra:
        meta.update(extra)

    stem = os.path.join(dirpath, f"{prefix}.{calendar.timestamp()}")
    if fmt == "cdf1":
        fname = stem + ".nc"
        buf = SnapshotBytesIO()
        _write_restart_cdf1(buf, arrays, meta)
        payload = buf.value           # netcdf_file closed the buffer
    elif fmt == "hdf5":
        # cdf1 and hdf5 restarts share the .nc suffix, as the reference's do
        fname = stem + ".nc"
        buf = SnapshotBytesIO()
        _write_restart_h5(buf, arrays, meta)
        payload = buf.getvalue()
    else:
        fname = stem + ".npz"
        arrays["_meta"] = np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        payload = buf.getvalue()
    write_bytes(fname, payload, writer,
                (pointer_file, fname + "\n") if pointer_file else None)
    return fname


def read_restart(path_or_pointer: str,
                 template: State) -> Tuple[State, Calendar]:
    """Load a restart (.npz or .nc, or the pointer file naming one).
    `template` gives the tracers, and each leaf's shape, dtype and device:
    every leaf is put on the template's device in the template's dtype."""
    path = path_or_pointer
    if not (path.endswith(".npz") or path.endswith(".nc")):
        with open(path_or_pointer) as f:
            path = f.read().strip()
    if path.endswith(".nc"):
        # cdf1 and hdf5 share the suffix: dispatch on the HDF5 magic bytes
        arrays, meta = (_read_restart_h5(path) if _is_hdf5(path)
                        else _read_restart_cdf1(path))
    else:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        meta = json.loads(bytes(arrays.pop("_meta")).decode())
    refs = state_leaves(template)
    nfile = sum(k.startswith("leaf_") for k in arrays)
    if nfile != len(refs):
        raise ValueError(f"{path}: {nfile} leaves, the state has "
                         f"{len(refs)}")
    leaves = []
    for i, ref in enumerate(refs):
        arr = arrays[f"leaf_{i}"]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: leaf_{i} has shape {arr.shape}, the "
                             f"state expects {tuple(ref.shape)}")
        leaves.append(torch.from_numpy(np.array(arr)).to(
            device=ref.device, dtype=ref.dtype))
    cal = Calendar(calendar_type=meta["calendar_type"], year=meta["year"],
                   month=meta["month"], day=meta["day"], sec=meta["sec"],
                   istep=meta["istep"], year_init=meta["year_init"])
    return state_from_leaves(template, leaves), cal
