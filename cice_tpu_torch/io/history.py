"""History output: multi-stream accumulation and writers (PyTorch port of
cice_tpu/io/history.py; reference ice_history.F90 `accum_hist`:2201,
ice_history_shared.F90 streams :101-133 and `construct_filename`:780, the
io_netcdf ice_history_write.F90 backend). The field registry is
`history_fields.build_fields`.

Each step `History.accum` extracts every registered field on the model's
device, stacks them with one `torch.cat` and adds the stack (or a stream's
rows of it) to one accumulator per averaging stream: one add per step. At a
stream boundary the accumulator comes to the host, where numpy divides it
by the number of steps accumulated and masks land, and one file is written
(netCDF-3 classic through scipy, HDF5 through h5py, or .npz), inline or
queued to the background writer (`writer=`). The averaging
state is not part of the model's restarts (as in the JAX driver);
`get_restart_payload` / `set_restart_payload` carry it for callers that
want it.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import constants as cst
from .async_writer import SnapshotBytesIO, write_bytes
from .history_fields import HistoryField, build_fields, nrows


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclass
class Stream:
    freq: str                  # 'y' 'm' 'd' 'h' '1' 'x'
    freq_n: int = 1
    avg: bool = True           # time-average vs instantaneous
    nacc: int = 0
    acc: Optional[torch.Tensor] = None    # (nrows, ny, nx) running sum
    # per-stream field subset (icefields_nml per-field frequency chars)
    fields: Optional[List[HistoryField]] = None
    rows: Optional[torch.Tensor] = None   # rows of the stack; None = all
    snap_idx: Optional[np.ndarray] = None  # rows written as snapshots
    last: Optional[torch.Tensor] = None   # last stack (snapshot fields)


class History:
    """Multi-stream accumulating history writer."""

    def __init__(self, cfg, grid, directory: Optional[str] = None,
                 writer=None):
        self.cfg = cfg
        self.writer = writer          # io.async_writer.AsyncWriter | None
        self.grid = grid
        self.fields = build_fields(cfg)
        self.dir = directory or cfg.setup.history_dir
        s = cfg.setup
        # per-field frequency overrides (reference icefields_nml f_* chars:
        # 'x' disables a field, 'md' puts it on the m and d streams,
        # None/'*' keeps it on every configured stream)
        fmap = dict(s.hist_field_freq)
        if fmap:
            self.fields = [
                dataclasses.replace(f, freq=fmap.get(f.name, f.freq))
                for f in self.fields]
        # hist_avg: one bool for all streams, or a per-stream tuple
        # (reference hist_avg is max_nstrm logicals, ice_in setup_nml)
        avg = s.hist_avg
        if not isinstance(avg, (tuple, list)):
            avg = (avg,) * len(s.histfreq)
        self.streams = [Stream(freq=f, freq_n=n, avg=bool(a))
                        for f, n, a in zip(s.histfreq, s.histfreq_n, avg)
                        if f != "x"]
        # resolve the per-stream membership and the union of fields that
        # need extracting each step. Multi-axis fields (dims) occupy
        # nrows(f) consecutive rows of the stack; the writers reassemble
        # them into one variable per field.
        self._snap_fields: List[HistoryField] = []
        stream_rows = [[] for _ in self.streams]
        stream_fields = [[] for _ in self.streams]
        stream_snap = [[] for _ in self.streams]
        row0 = 0
        for f in self.fields:
            if f.freq is not None and ("x" in f.freq or not f.freq):
                continue
            members = [j for j, st in enumerate(self.streams)
                       if f.freq is None or "*" in f.freq
                       or st.freq in f.freq]
            if not members:
                continue
            self._snap_fields.append(f)
            k = nrows(f)
            for j in members:
                if f.snapshot:
                    stream_snap[j].extend(
                        range(len(stream_rows[j]),
                              len(stream_rows[j]) + k))
                stream_fields[j].append(f)
                stream_rows[j].extend(range(row0, row0 + k))
            row0 += k
        self._total_rows = row0
        for st, rows, flds, sn in zip(self.streams, stream_rows,
                                      stream_fields, stream_snap):
            st.fields = flds
            st.rows = (None if rows == list(range(row0))
                       else torch.as_tensor(rows, dtype=torch.long,
                                            device=grid.device))
            st.snap_idx = np.asarray(sn, np.int64)

    # -- per-step accumulation (accum_hist, ice_history.F90:2201) ----------
    def accum(self, state, flux, forcing=None):
        """Add this step's fields to every stream (forcing fields are zeros
        without `forcing`)."""
        shape = tuple(self.grid.shape)
        dt = state.aicen.dtype

        def _x(f):
            if f.needs_forcing:
                if forcing is None:
                    return torch.zeros((nrows(f),) + shape, dtype=dt,
                                       device=state.aicen.device)
                out = f.extract(state, flux, self.grid, forcing)
            else:
                out = f.extract(state, flux, self.grid)
            return out.reshape((-1,) + shape).to(dt)
        snap = torch.cat([_x(f) for f in self._snap_fields], 0)
        for st in self.streams:
            sub = snap if st.rows is None else snap.index_select(0, st.rows)
            if st.avg:
                if st.acc is None:
                    st.acc = sub.clone()
                else:
                    st.acc.add_(sub)
                st.nacc += 1
            else:
                st.acc = sub
                st.nacc = 1
            if st.snap_idx.size:
                st.last = sub

    # -- write when calendar says so ---------------------------------------
    def maybe_write(self, calendar, fmt: str = "cdf1") -> List[str]:
        written = []
        for st in self.streams:
            if st.nacc and calendar.is_boundary(st.freq, st.freq_n,
                                                self.cfg.setup.dt):
                written.append(self.write_stream(st, calendar, fmt))
                st.acc = None
                st.nacc = 0
        return written

    def stream_data(self, st: Stream) -> np.ndarray:
        """The stream's rows as written: the sum over the steps
        accumulated divided by their number (snapshot rows: the last
        value), on the host."""
        data = _np(st.acc) / max(st.nacc, 1)
        if st.snap_idx.size and st.last is not None:
            # snapshot fields (f_aisnap/f_hisnap) write the last value even
            # on averaging streams
            data[st.snap_idx] = _np(st.last)[st.snap_idx]
        return data

    def write_stream(self, st: Stream, calendar, fmt: str = "cdf1") -> str:
        os.makedirs(self.dir, exist_ok=True)
        data = self.stream_data(st)
        mask = _np(self.grid.hm) > 0.5
        base = f"{self.cfg.setup.history_file}.{st.freq}.{calendar.timestamp()}"
        buf = SnapshotBytesIO()
        if fmt == "npz":
            # one array per field on its own axes, unmasked (the JAX
            # package's npz writer stores row i under field i's name, which
            # misnames every field after the first multi-row one)
            path = os.path.join(self.dir, base + ".npz")
            np.savez(buf, **self._field_arrays(data, st))
            payload = buf.getvalue()
        elif fmt == "hdf5":
            # netCDF-4-style HDF5 (reference history_format='hdf5' with
            # history_deflate/history_chunksize)
            path = os.path.join(self.dir, base + ".nc")
            self._write_hdf5(buf, data, mask, calendar, st)
            payload = buf.getvalue()
        elif fmt in ("nc", "cdf1"):    # netCDF-3 classic
            path = os.path.join(self.dir, base + ".nc")
            self._write_netcdf(buf, data, mask, calendar, st)
            payload = buf.value       # netcdf_file closed the buffer
        else:
            raise ValueError(f"unknown history format {fmt!r}")
        write_bytes(path, payload, self.writer)
        return path

    def _field_arrays(self, data, st) -> dict:
        """{field name: its rows of `data` shaped (*dim sizes, ny, nx)}."""
        out, cur = {}, 0
        for fld in st.fields:
            k = nrows(fld)
            sizes = tuple(sz for _d, sz in fld.dims)
            out[fld.name] = data[cur:cur + k].reshape(
                sizes + tuple(self.grid.shape))
            cur += k
        return out

    # CF time/coordinate helpers -------------------------------------------

    def _time_meta(self, calendar, st):
        """(time_value, units, calendar_name, (bounds_lo, bounds_hi)).

        CF conventions (reference io_netcdf/ice_history_write.F90:261-295
        writes time:units/calendar/bounds + the time_bounds variable)."""
        tval = calendar.elapsed_seconds / 86400.0
        units = (f"days since {calendar.year_init:04d}-01-01 00:00:00")
        cal = {"noleap": "noleap", "gregorian": "proleptic_gregorian",
               "360day": "360_day"}.get(calendar.calendar_type, "noleap")
        span = st.nacc * self.cfg.setup.dt / 86400.0 if st.avg else 0.0
        return tval, units, cal, (tval - span, tval)

    def _axis_coord(self, name, size):
        """Coordinate values/units/long_name for an extra history axis
        (reference coordinate vars NCAT/VGRDi/VGRDs,
        ice_history_shared.F90:101-123)."""
        cfg = self.cfg
        if name == "nc":
            from ..columns.itd import category_bounds
            hm = np.asarray(category_bounds(
                cfg.domain.ncat, cfg.grid.kcatbound, cfg.domain.nilyr,
                cfg.thermo.kitd))
            return ("NCAT", hm[1:1 + size], "m",
                    "category maximum thickness")
        label = {"nkice": ("VGRDi", "ice vertical levels"),
                 "nksnow": ("VGRDs", "snow vertical levels")}
        vname, lname = label.get(name, (name.upper(), name))
        return (vname, np.arange(1, size + 1, dtype=np.float64), "1", lname)

    def _field_dims(self, st):
        """Union of extra axes used by this stream's fields."""
        dims = {}
        for f in st.fields:
            for d, sz in f.dims:
                if dims.setdefault(d, sz) != sz:
                    raise ValueError(f"dim {d}: conflicting sizes")
        return dims

    def _write_hdf5(self, fileobj, data, mask, calendar, st):
        """HDF5 history body via h5py: per-field chunked+deflated datasets
        with CF attrs and dimension scales (the shape netCDF-4 writes)."""
        import h5py

        ny, nx = self.grid.shape
        cy, cx = self.cfg.setup.history_chunksize
        lvl = int(self.cfg.setup.history_deflate)
        comp = dict(compression="gzip", compression_opts=lvl) if lvl else {}
        tval, tunits, cal, tb = self._time_meta(calendar, st)
        with h5py.File(fileobj, "w") as f:
            f.attrs["Conventions"] = "CF-1.0"
            f.attrs["source"] = "cice_tpu sea ice model"
            t = f.create_dataset("time", data=np.asarray([tval], np.float64))
            t.attrs["units"] = tunits
            t.attrs["calendar"] = cal
            t.attrs["bounds"] = "time_bounds"
            t.make_scale("time")
            f.create_dataset("time_bounds",
                             data=np.asarray([tb], np.float64))
            scales = {}
            for d, sz in self._field_dims(st).items():
                vname, vals, vunits, lname = self._axis_coord(d, sz)
                c = f.create_dataset(vname, data=vals.astype(np.float64))
                c.attrs["units"] = vunits
                c.attrs["long_name"] = lname
                c.make_scale(d)
                scales[d] = c
            for nm, arr in (("TLAT", self.grid.TLAT),
                            ("TLON", self.grid.TLON)):
                v = f.create_dataset(
                    nm, data=(_np(arr) * cst.rad_to_deg).astype(np.float32),
                    **comp)
                v.attrs["units"] = "degrees"
            arrays = self._field_arrays(data, st)
            for fld in st.fields:
                out = arrays[fld.name]
                if fld.cell_mask:
                    out = np.where(mask, out, np.float32(cst.spval))
                chunks = ((1,) + tuple(1 for _ in fld.dims) +
                          (min(cy, ny) if cy else ny,
                           min(cx, nx) if cx else nx))
                v = f.create_dataset(fld.name, data=out[None]
                                     .astype(np.float32),
                                     chunks=chunks, **comp)
                v.dims[0].attach_scale(t)
                for ax, (d, _sz) in enumerate(fld.dims):
                    v.dims[1 + ax].attach_scale(scales[d])
                v.attrs["units"] = fld.units
                v.attrs["long_name"] = fld.long_name
                v.attrs["missing_value"] = np.float32(cst.spval)
                v.attrs["coordinates"] = "TLON TLAT"
                v.attrs["cell_methods"] = (
                    "time: point" if (fld.snapshot or not st.avg)
                    else "time: mean")

    def _write_netcdf(self, fileobj, data, mask, calendar, st):
        """NetCDF-3 classic via scipy (reference io_netcdf ice_history_write
        defines dims/coords then per-field variables; same layout incl.
        time_bounds/cell_methods CF metadata and the 3Dc/4Di axes)."""
        from scipy.io import netcdf_file

        ny, nx = self.grid.shape
        tval, tunits, cal, tb = self._time_meta(calendar, st)
        with netcdf_file(fileobj, "w") as f:
            f.Conventions = b"CF-1.0"
            f.source = b"cice_tpu sea ice model"
            f.createDimension("time", 1)
            f.createDimension("d2", 2)
            f.createDimension("nj", ny)
            f.createDimension("ni", nx)
            t = f.createVariable("time", "f8", ("time",))
            t[:] = tval
            t.units = tunits.encode()
            t.calendar = cal.encode()
            t.bounds = b"time_bounds"
            tbv = f.createVariable("time_bounds", "f8", ("time", "d2"))
            tbv[:] = np.asarray([tb], np.float64)
            for d, sz in self._field_dims(st).items():
                f.createDimension(d, sz)
                vname, vals, vunits, lname = self._axis_coord(d, sz)
                c = f.createVariable(vname, "f8", (d,))
                c[:] = vals.astype(np.float64)
                c.units = vunits.encode()
                c.long_name = lname.encode()
            for nm, arr in (("TLAT", self.grid.TLAT),
                            ("TLON", self.grid.TLON)):
                v = f.createVariable(nm, "f4", ("nj", "ni"))
                v[:] = _np(arr) * cst.rad_to_deg
                v.units = b"degrees"
            arrays = self._field_arrays(data, st)
            for fld in st.fields:
                out = arrays[fld.name]
                dnames = tuple(d for d, _sz in fld.dims)
                v = f.createVariable(fld.name, "f4",
                                     ("time",) + dnames + ("nj", "ni"))
                if fld.cell_mask:
                    out = np.where(mask, out, np.float32(cst.spval))
                v[:] = out[None].astype(np.float32)
                v.units = fld.units.encode()
                v.long_name = fld.long_name.encode()
                v.missing_value = np.float32(cst.spval)
                v.coordinates = b"TLON TLAT"
                v.cell_methods = (b"time: point"
                                  if (fld.snapshot or not st.avg)
                                  else b"time: mean")

    # -- history-restart payload (exact averaging across restarts) ---------
    def get_restart_payload(self) -> dict:
        out = {}
        for i, st in enumerate(self.streams):
            out[f"hist_nacc_{i}"] = np.asarray(st.nacc)
            if st.acc is not None:
                out[f"hist_acc_{i}"] = _np(st.acc)
            if st.last is not None:
                out[f"hist_last_{i}"] = _np(st.last)
        return out

    def set_restart_payload(self, payload: dict):
        dev = self.grid.device
        for i, st in enumerate(self.streams):
            key = f"hist_acc_{i}"
            if key in payload:
                st.acc = torch.as_tensor(payload[key], device=dev).clone()
                st.nacc = int(payload[f"hist_nacc_{i}"])
            if f"hist_last_{i}" in payload:
                st.last = torch.as_tensor(payload[f"hist_last_{i}"],
                                          device=dev).clone()
