"""PyTorch port vs JAX package: history (cice_tpu_torch/io/history.py and
history_fields.py) against cice_tpu/io/history.py.

- The registry: names, units, long names, dims, masks and order equal the
  JAX registry for Config(), gx1pop_step and hist_cmip=True.
- Every extractor on the same state, flux, forcing and grid (one f64 JAX
  step of the gx1pop configuration at 48x40, converted): within 1e-12 of
  the field's largest value.
- A 3-step f64 Model(enable_history=True) in both packages (the port on
  the JAX grid): the accumulated streams agree to test_torch_step.py's f64
  tolerance (1e-8 of each field's largest value, with the absolute floors
  below for fields that hold rounding residue), and the cdf1, npz and hdf5
  files they write agree to that tolerance plus one float32 rounding (the
  files hold float32). Their CF metadata and coordinate variables are
  equal. In npz the port writes every field whole on its own axes, where
  the JAX writer stores row i of the stack under field i's name (a fault
  of the reference that misnames every field after the first multi-row
  one): the port's npz is held against the JAX stream's rows.
- Stream membership (hist_field_freq) and snapshot rows, the restart
  payload round trip, and the biogeochemistry's groups (bgc, zbgc,
  hbrine, aerosols, isotopes) against the JAX package's registration.

The JAX side runs remap_kernel='xla' (its fused kernels are f32-only); on
CPU tensors every port wrapper reaches its plain version.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

from cice_tpu.config import Config  # noqa: E402
from cice_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from cice_tpu.io import history as jhist  # noqa: E402
from cice_tpu.model.driver import Model as JModel  # noqa: E402
from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.core.halo import BC as TBC  # noqa: E402
from cice_tpu_torch.io import history as thist  # noqa: E402
from cice_tpu_torch.io import history_fields as tfields  # noqa: E402
from cice_tpu_torch.model import driver as tdriver  # noqa: E402

NX, NY, NDTE, STEPS = 48, 40, 40, 3
RTOL = 1e-8            # test_torch_step.py's f64 tolerance
EXTRACT_RTOL = 1e-12   # the same inputs through both packages
F32_EPS = float(np.finfo(np.float32).eps)

# Absolute floors (f64) for fields that hold rounding residue, from
# test_torch_step.py's FLOORS in each field's history units: in midwinter
# the top-melt energy is the residue of the converged surface balance
# (~1e-17 m of snow melt per step); the ponds collect it (dpnd_*, fpond)
# and apnd = sqrt(volume / aspect) turns 1e-17 into ~4e-9 (apond, apeff,
# albpnd and their cell and category means); daidtt is the rounding of an
# area difference over dt (history: %/day, x 8.64e6). Where no ice has
# ridged, the level-ice fractions alvl, vlvl are 1 to rounding, so the
# ridged area and volume 1 - alvl are rounding residue (a few 1e-16 of
# aicen <= 1 and of vicen <= ~5 m), and sirdgthick = vrdg / max(ardg,
# puny) divides residue by puny = 1e-11.
_MELT, _POND, _RDG = 1e-12, 1e-7, 1e-14
FLOORS = {
    "melts": _MELT, "meltt": _MELT, "dpnd_initial": _MELT,
    "dpnd_initialn": _MELT, "dpnd_ridge": 1e-15, "dpnd_melt": 1e-15,
    "fpond": _MELT, "siflfwdrain": _MELT, "meltsliq": _MELT,
    "sisndmassmelt": _MELT * 330.0 / 3600.0,
    "melttn_ai": _MELT,
    "apond": _POND, "apond_ai": _POND, "apondn": _POND, "simpconc": _POND,
    "apeff": _POND, "apeff_ai": _POND, "apeffn": _POND, "simpeffconc": _POND,
    "albpnd": _POND, "hpond": _POND, "hpond_ai": _POND, "hpondn": _POND,
    "simpthick": _POND,
    "daidtt": 1e-15 * 8.64e6, "sidconcth": 1e-15,
    "ardg": _RDG, "ardgn": _RDG, "sirdgconc": _RDG, "vrdg": _RDG,
    "vrdgn": _RDG, "sirdgthick": _RDG / 1e-11,
}

# history streams of the 3-step runs: a daily average (not due in 3 hourly
# steps; written explicitly in every format) and an instantaneous stream
# every 3 steps (written by Model.step in cdf1); aice only on the daily
# stream, hi only on the 3-step one, hs on none
HIST = {"setup.histfreq": ("d", "1", "x", "x", "x"),
        "setup.histfreq_n": (1, STEPS, 1, 1, 1),
        "setup.hist_avg": (True, False, True, True, True),
        "setup.hist_cmip": True,
        "setup.hist_field_freq": (("aice", "d"), ("hi", "1"), ("hs", "x"))}


def _cfgs(root, **over):
    base = {"dynamics.ndte": NDTE, "dtype": "float64",
            "setup.history_dir": os.path.join(str(root), "hist"), **over}
    tcfg = tconfig.gx1pop_step(NX, NY).with_overrides(**base)
    g = tcfg.grid
    jcfg = Config().with_overrides(**{
        "grid.nx_global": NX, "grid.ny_global": NY,
        "grid.grid_format": "pop_bin", "grid.grid_type": "displaced_pole",
        "grid.grid_file": g.grid_file, "grid.kmt_file": g.kmt_file,
        "grid.ew_boundary_type": "cyclic", "dynamics.coriolis": "latitude",
        "dynamics.remap_kernel": "xla", **base})
    return tcfg, jcfg


def _np_fields(obj):
    """{field: array} of a JAX dataclass (dict fields: {name: array})."""
    out = {}
    for f in dataclasses.fields(obj):
        if f.name in ("bc", "nx_global", "ny_global"):
            continue
        v = getattr(obj, f.name)
        out[f.name] = ({k: np.asarray(x) for k, x in v.items()}
                       if isinstance(v, dict) else np.asarray(v))
    return out


def _extract(f, s, fl, g, fc):
    return f.extract(s, fl, g, fc) if f.needs_forcing else \
        f.extract(s, fl, g)


def _port_grid(jgrid):
    return convert.grid_from_numpy(_np_fields(jgrid),
                                   TBC(jgrid.bc.ew, jgrid.bc.ns), "cpu")


def _stream_np(h, st):
    """{field name: (rows, ny, nx) written values} of a stream."""
    data = (h.stream_data(st) if isinstance(h, thist.History) else
            _jax_stream_data(st))
    out, cur = {}, 0
    for f in st.fields:
        k = tfields.nrows(f) if isinstance(h, thist.History) else \
            jhist._nrows(f)
        out[f.name] = data[cur:cur + k]
        cur += k
    return out


def _jax_stream_data(st):
    """What cice_tpu's History.write_stream writes for a stream."""
    data = np.asarray(st.acc) / max(st.nacc, 1)
    if st.snap_idx.size and st.last is not None:
        data[st.snap_idx] = np.asarray(st.last)[st.snap_idx]
    return data


def _write(h, st, cal, root, fmt):
    """Write the stream in `fmt` into its own directory; the path."""
    h.dir = os.path.join(str(root), fmt)
    return h.write_stream(st, cal, fmt)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX and port 3-step f64 runs with history, the port on the JAX
    grid; the first step's state, flux and forcing with JAX's extraction
    of every field on them."""
    troot = tmp_path_factory.mktemp("hist_port")
    jroot = tmp_path_factory.mktemp("hist_jax")
    _, jcfg = _cfgs(jroot, **HIST)
    tcfg, _ = _cfgs(troot, **HIST)
    jm = JModel(jcfg, enable_history=True)
    jm.step()
    first = dict(state=_np_fields(jm.state), flux=_np_fields(jm.flux),
                 forcing=_np_fields(jm.forcing))
    jext = {f.name: np.asarray(_extract(f, jm.state, jm.flux, jm.grid,
                                        jm.forcing))
            for f in jm.history.fields}
    for _ in range(STEPS - 1):
        jm.step()
    tm = tdriver.Model(tcfg, grid=_port_grid(jm.grid), device="cpu",
                       enable_history=True)
    tm.run(STEPS)
    return dict(jm=jm, tm=tm, first=first, jext=jext, jroot=jroot,
                troot=troot, tcfg=tcfg, jcfg=jcfg)


def _assert_close(got, ref, name, rtol=RTOL, f32=False):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    fin = np.isfinite(ref)
    scale = float(np.abs(ref[fin]).max()) if fin.any() else 0.0
    atol = max(rtol * scale, FLOORS.get(name, 0.0))
    np.testing.assert_allclose(got, ref, rtol=rtol + (F32_EPS if f32 else 0),
                               atol=atol, err_msg=name)


def _registry(fields, nrows):
    return [(f.name, f.units, f.long_name, tuple(f.dims), f.cell_mask,
             f.needs_forcing, f.snapshot, nrows(f)) for f in fields]


@pytest.mark.parametrize("which,count", [
    ("Config", (221, 417)), ("gx1pop_step", (221, 417)),
    ("hist_cmip", (287, 499))])
def test_registry_matches_jax(which, count):
    if which == "Config":
        tcfg, jcfg = tconfig.Config(), Config()
    else:
        over = {"setup.hist_cmip": True} if which == "hist_cmip" else {}
        tcfg, jcfg = _cfgs("/nonexistent", **over)
    got = _registry(tfields.build_fields(tcfg), tfields.nrows)
    ref = _registry(jhist.build_fields(jcfg), jhist._nrows)
    assert got == ref
    assert (len(got), sum(r[-1] for r in got)) == count


def test_every_extractor_matches_jax_f64(runs):
    """Each field's extract on the first step's state, flux and forcing
    (converted from the JAX run) and the JAX grid, against JAX's."""
    first, jm = runs["first"], runs["jm"]
    s = convert.state_from_numpy(first["state"], "cpu")
    fl = convert.fluxout_from_numpy(first["flux"], "cpu")
    fc = convert.forcing_from_numpy(first["forcing"], "cpu")
    g = _port_grid(jm.grid)
    fields = tfields.build_fields(runs["tcfg"])
    assert [f.name for f in fields] == list(runs["jext"])
    for f in fields:
        got = _extract(f, s, fl, g, fc)
        assert got.dtype == torch.float64, f.name
        _assert_close(got.numpy(), runs["jext"][f.name], f.name,
                      rtol=EXTRACT_RTOL)
    assert float(np.abs(runs["jext"]["sig1"]).max()) > 0.0   # ice stressed
    assert float(np.abs(runs["jext"]["sidmasstranx"]).max()) > 0.0


def test_streams_match_jax_after_3_steps(runs):
    """Membership, counts and the daily stream's 3-step averages."""
    jh, th = runs["jm"].history, runs["tm"].history
    assert len(th.streams) == len(jh.streams) == 2
    for ts, js in zip(th.streams, jh.streams):
        assert (ts.freq, ts.freq_n, ts.avg) == (js.freq, js.freq_n, js.avg)
        assert [f.name for f in ts.fields] == [f.name for f in js.fields]
        np.testing.assert_array_equal(ts.snap_idx, js.snap_idx)
        assert (ts.rows is None) == (js.rows is None)
        if js.rows is not None:
            np.testing.assert_array_equal(ts.rows.numpy(), js.rows)
    daily, every3 = th.streams
    names = [f.name for f in daily.fields]
    assert "aice" in names and "hi" not in names and "hs" not in names
    assert "hi" in [f.name for f in every3.fields]
    assert daily.nacc == jh.streams[0].nacc == STEPS
    assert every3.nacc == jh.streams[1].nacc == 0      # written at step 3
    got, ref = _stream_np(th, daily), _stream_np(jh, jh.streams[0])
    for name in ref:
        _assert_close(got[name], ref[name], name)
    # snapshot rows hold the last step, the others the 3-step mean
    assert np.array_equal(got["aisnap"][0],
                          runs["tm"].state.aice.numpy())
    assert float(np.abs(ref["congel"]).max()) > 0.0


def _read_nc(path):
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        glob = dict(f._attributes)
        dims = dict(f.dimensions)
        var = {k: (v.dimensions, dict(v._attributes), np.array(v[:]))
               for k, v in f.variables.items()}
    return glob, dims, var


COORDS = ("time", "time_bounds", "NCAT", "VGRDi", "VGRDs", "TLAT", "TLON")


def _compare_nc(tpath, jpath):
    tg, td, tv = _read_nc(tpath)
    jg, jd, jv = _read_nc(jpath)
    assert tg == jg and td == jd
    assert list(tv) == list(jv)
    for k in jv:
        assert tv[k][0] == jv[k][0], k
        assert tv[k][1] == jv[k][1], k
        if k in COORDS:
            np.testing.assert_array_equal(tv[k][2], jv[k][2], err_msg=k)
        else:
            assert tv[k][2].dtype == jv[k][2].dtype == np.dtype(">f4")
            _assert_close(tv[k][2], jv[k][2], k, f32=True)


@pytest.mark.parametrize("fmt", ["cdf1", "npz", "hdf5"])
def test_written_files_match_jax(runs, fmt, tmp_path):
    """The daily stream after 3 steps, written by both packages."""
    if fmt == "hdf5":
        h5py = pytest.importorskip("h5py")
    th, jh = runs["tm"].history, runs["jm"].history
    tp = _write(th, th.streams[0], runs["tm"].calendar, tmp_path / "port",
                fmt)
    jp = _write(jh, jh.streams[0], runs["jm"].calendar, tmp_path / "jax",
                fmt)
    assert os.path.basename(tp) == os.path.basename(jp) == \
        "iceh.d.2005-01-01-10800" + (".npz" if fmt == "npz" else ".nc")
    if fmt == "cdf1":
        _compare_nc(tp, jp)
    elif fmt == "npz":
        # the port writes each field whole on its own axes; the JAX writer
        # stores row i under field i's name, so its arrays carry the right
        # field only up to the first multi-row one (aicen)
        ref = _stream_np(jh, jh.streams[0])
        fields = th.streams[0].fields
        first_multi = next(i for i, f in enumerate(fields) if f.dims)
        with np.load(tp) as t, np.load(jp) as j:
            assert t.files == j.files == [f.name for f in fields]
            for i, f in enumerate(fields):
                sizes = tuple(sz for _d, sz in f.dims)
                assert t[f.name].shape == sizes + (NY, NX), f.name
                _assert_close(t[f.name], ref[f.name].reshape(
                    sizes + (NY, NX)), f.name)
                if i < first_multi:
                    _assert_close(t[f.name], j[f.name], f.name)
    else:
        with h5py.File(tp, "r") as t, h5py.File(jp, "r") as j:
            assert dict(t.attrs) == dict(j.attrs)
            assert list(t) == list(j)
            for k in j:
                ta = {a: v for a, v in t[k].attrs.items()
                      if a not in ("DIMENSION_LIST", "REFERENCE_LIST")}
                ja = {a: v for a, v in j[k].attrs.items()
                      if a not in ("DIMENSION_LIST", "REFERENCE_LIST")}
                assert ta.keys() == ja.keys(), k
                for a in ja:
                    assert np.array_equal(ta[a], ja[a]), (k, a)
                assert t[k].chunks == j[k].chunks, k
                if k in COORDS:
                    np.testing.assert_array_equal(t[k][()], j[k][()],
                                                  err_msg=k)
                else:
                    _assert_close(t[k][()], j[k][()], k, f32=True)


def test_model_writes_the_due_stream_like_jax(runs):
    """The 3-step instantaneous stream, written by Model.step in cdf1."""
    name = "iceh.1.2005-01-01-10800.nc"
    tdir = runs["tcfg"].setup.history_dir
    jdir = runs["jcfg"].setup.history_dir
    assert os.listdir(tdir) == os.listdir(jdir) == [name]
    _compare_nc(os.path.join(tdir, name), os.path.join(jdir, name))
    _, _, var = _read_nc(os.path.join(tdir, name))
    assert var["hi"][1]["cell_methods"] == b"time: point"
    assert "aice" not in var and "hs" not in var


@pytest.mark.parametrize("over", [
    {"setup.histfreq": ("m", "d", "1", "h", "x"),
     "setup.histfreq_n": (1, 1, 2, 6, 1),
     "setup.hist_field_freq": (("aice", "md"), ("hi", "x"), ("aisnap", "d"),
                               ("Tinz", "1"), ("sst", "*"), ("vicen", "h"))},
    {"setup.histfreq": ("1", "x", "x", "x", "x"),
     "setup.hist_avg": False},
    {"setup.histfreq": ("d", "m", "x", "x", "x"),
     "setup.hist_avg": (False, True, True, True, True),
     "setup.hist_field_freq": (("hisnap", "m"),)}],
    ids=["per-field", "instantaneous", "snapshot-on-mean"])
def test_stream_membership_and_snapshot_rows_match_jax(over):
    tcfg, jcfg = _cfgs("/nonexistent", **over)
    jg = jmake_grid(jcfg)
    th = thist.History(tcfg, _port_grid(jg))
    jh = jhist.History(jcfg, jg)
    assert th._total_rows == jh._total_rows
    assert [f.name for f in th._snap_fields] == \
        [f.name for f in jh._snap_fields]
    assert len(th.streams) == len(jh.streams)
    for ts, js in zip(th.streams, jh.streams):
        assert (ts.freq, ts.freq_n, ts.avg) == (js.freq, js.freq_n, js.avg)
        assert [f.name for f in ts.fields] == [f.name for f in js.fields]
        np.testing.assert_array_equal(ts.snap_idx, js.snap_idx)
        if js.rows is None:
            assert ts.rows is None
        else:
            np.testing.assert_array_equal(ts.rows.numpy(), js.rows)


def test_restart_payload_round_trip(runs):
    """get_restart_payload / set_restart_payload carry the running sums: a
    History restored from the payload accumulates and writes as the one it
    came from."""
    tm = runs["tm"]
    h = tm.history
    payload = h.get_restart_payload()
    assert int(payload["hist_nacc_0"]) == STEPS
    assert payload["hist_acc_0"].shape == (h.streams[0].acc.shape)
    h2 = thist.History(runs["tcfg"], tm.grid)
    h2.set_restart_payload(payload)
    for a, b in zip(h.streams, h2.streams):
        assert a.nacc == b.nacc
        for x, y in ((a.acc, b.acc), (a.last, b.last)):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)
    h_copy = thist.History(runs["tcfg"], tm.grid)
    h_copy.set_restart_payload(payload)
    h2.accum(tm.state, tm.flux, tm.forcing)
    h_copy.accum(tm.state, tm.flux, tm.forcing)
    np.testing.assert_array_equal(h2.stream_data(h2.streams[0]),
                                  h_copy.stream_data(h_copy.streams[0]))
    assert h2.streams[0].nacc == STEPS + 1
    # the payload is what JAX's History carries, key for key
    jp = runs["jm"].history.get_restart_payload()
    assert payload.keys() == jp.keys()


UNPORTED = {
    "bgc": {"zbgc.skl_bgc": True},
    "zbgc": {"zbgc.z_tracers": True},
    "hbrine": {"tracers.tr_brine": True},
    "aero": {"tracers.tr_aero": True, "domain.n_aero": 1},
    "iso": {"tracers.tr_iso": True, "domain.n_iso": 1},
}


@pytest.mark.parametrize("group", list(UNPORTED))
def test_unported_groups_raise_naming_roadmap(runs, group):
    """(Kept name: these groups raised until the biogeochemistry was
    ported.) Each group's History builds, with the JAX package's field
    names, units, dimensions and rows in its order."""
    tcfg, jcfg = _cfgs("/nonexistent", **UNPORTED[group])
    h = thist.History(tcfg, runs["tm"].grid)
    got = _registry(h.fields, tfields.nrows)
    assert got == _registry(jhist.build_fields(jcfg), jhist._nrows)
    names = {f.name for f in h.fields}
    assert {"bgc": "algal_N001", "zbgc": "bgc_N001", "hbrine": "hbrine",
            "aero": "aerosnossl001", "iso": "isosno001"}[group] in names