"""Restarts of the PyTorch port (cice_tpu_torch/io/restart.py and the
Model's dumps): exact resumption, the pointer file, the early checkpoint
before each abort, and restart files that load into either package.

The contract is bit for bit: a run of 3 steps, a dump and a fresh Model
that continues for 3 more equals the uninterrupted 6-step run in every
leaf (`torch.equal`) and in the calendar, in npz, cdf1 and hdf5, f32 and
f64. The cross-package files are compared exactly too: the JAX package's
`State` is built from the port's numpy arrays, so no JAX step compiles.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax.numpy as jnp  # noqa: E402

from cice_tpu.calendar import Calendar as JCalendar  # noqa: E402
from cice_tpu.io import restart as jrestart  # noqa: E402
from cice_tpu.model.state import State as JState  # noqa: E402
from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.io import restart as trestart  # noqa: E402
from cice_tpu_torch.model import diagnostics as tdiag  # noqa: E402
from cice_tpu_torch.model import driver as tdriver  # noqa: E402
from cice_tpu_torch.model.state import state_leaves  # noqa: E402

NX, NY, NDTE = 48, 40, 40
FORMATS = ("npz", "cdf1", "hdf5")

#: the leaf order `jax.tree.flatten` gives the JAX State of the default
#: config: fields in declaration order, tracers in sorted key order
JAX_LEAF_NAMES = (
    ["aicen", "vicen", "vsnon"]
    + [f"trcrn.{k}" for k in ("FY", "Tsfcn", "alvl", "apnd", "hpnd", "iage",
                              "ipnd", "qice", "qsno", "sice", "vlvl")]
    + ["uvel", "vvel", "uvelE", "vvelE", "uvelN", "vvelN", "stressp",
       "stressm", "stress12", "a11", "a12", "sst", "frzmlt", "iceUmask",
       "mlt_onset", "frz_onset"])


def _cfg(dtype, root, **over):
    return tconfig.gx1pop_step(NX, NY).with_overrides(**{
        "dynamics.ndte": NDTE, "dtype": dtype,
        "setup.restart_dir": os.path.join(str(root), "restart"),
        "setup.pointer_file": os.path.join(str(root), "restart",
                                           "ice.restart_file"),
        **over})


def _assert_states_equal(a, b):
    la, lb = state_leaves(a), state_leaves(b)
    assert len(la) == len(lb) == len(JAX_LEAF_NAMES)
    for name, x, y in zip(JAX_LEAF_NAMES, la, lb):
        assert x.dtype == y.dtype and x.device == y.device, name
        assert torch.equal(x, y), name


def _pointer(path):
    with open(path) as f:
        return f.read().strip()


@pytest.fixture(scope="module", params=["float32", "float64"])
def runs(request, tmp_path_factory):
    """The uninterrupted 6-step run: the driver dumps npz at steps 3 and 6
    (dumpfreq='1', dumpfreq_n=3); at step 3 the pointer file is copied and
    a cdf1 and an hdf5 restart are written, each with its own pointer."""
    dtype = request.param
    root = tmp_path_factory.mktemp(f"restart_{dtype}")
    cfg = _cfg(dtype, root, **{"setup.dumpfreq": "1",
                               "setup.dumpfreq_n": 3})
    m = tdriver.Model(cfg, device="cpu")
    m.run(3)
    ptrs = {"npz": os.path.join(str(root), "ptr_npz")}
    shutil.copy(cfg.setup.pointer_file, ptrs["npz"])
    for fmt in ("cdf1", "hdf5"):
        if fmt == "hdf5" and not _have_h5py():
            continue
        ptrs[fmt] = os.path.join(str(root), f"ptr_{fmt}")
        trestart.write_restart(os.path.join(str(root), fmt), m.state,
                               m.calendar, ptrs[fmt], fmt=fmt)
    at3 = (m.state, m.calendar)
    m.run(3)
    return dict(dtype=dtype, root=root, cfg=cfg, model=m, ptrs=ptrs,
                at3=at3)


def _have_h5py():
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


@pytest.mark.parametrize("fmt", FORMATS)
def test_continued_run_equals_uninterrupted_bit_for_bit(runs, fmt):
    if fmt == "hdf5":
        pytest.importorskip("h5py")
    # the continued run reads and then rewrites its own pointer file
    cont = os.path.join(str(runs["root"]), f"cont_{fmt}")
    os.makedirs(cont, exist_ok=True)
    ptr = shutil.copy(runs["ptrs"][fmt], os.path.join(cont, "pointer"))
    cfg = runs["cfg"].with_overrides(**{
        "setup.runtype": "continue", "setup.restart_format": fmt,
        "setup.pointer_file": ptr, "setup.restart_dir": cont})
    b = tdriver.Model(cfg, device="cpu")
    state3, cal3 = runs["at3"]
    _assert_states_equal(b.state, state3)
    assert b.calendar == cal3 and b.istep == 3
    b.run(3)
    a = runs["model"]
    _assert_states_equal(b.state, a.state)
    assert b.calendar == a.calendar
    assert b.calendar.timestamp() == a.calendar.timestamp() == \
        "2005-01-01-21600"
    # the continued run dumps at step 6 in its own format, the same name
    ext = ".npz" if fmt == "npz" else ".nc"
    assert _pointer(cfg.setup.pointer_file) == os.path.join(
        cfg.setup.restart_dir, "iced.2005-01-01-21600" + ext)


def test_dumpfreq_writes_and_the_pointer_names_the_latest(runs):
    cfg = runs["cfg"]
    d = cfg.setup.restart_dir
    assert sorted(os.listdir(d)) == ["ice.restart_file",
                                     "iced.2005-01-01-10800.npz",
                                     "iced.2005-01-01-21600.npz"]
    assert _pointer(cfg.setup.pointer_file) == os.path.join(
        d, "iced.2005-01-01-21600.npz")
    assert _pointer(runs["ptrs"]["npz"]) == os.path.join(
        d, "iced.2005-01-01-10800.npz")
    # reading the pointer or the file it names gives the same restart
    st, cal = trestart.read_restart(cfg.setup.pointer_file,
                                    runs["model"].state)
    _assert_states_equal(st, runs["model"].state)
    assert cal == runs["model"].calendar


def test_dump_last_and_run_length_from_npt(tmp_path):
    """run() without a count takes setup.npt in setup.npt_unit and writes
    the final restart when dump_last is set; no dump at dumpfreq='y'."""
    cfg = _cfg("float32", tmp_path, **{
        "setup.npt": 2, "setup.npt_unit": "h", "setup.dump_last": True,
        "setup.restart_format": "cdf1"})
    m = tdriver.Model(cfg, device="cpu")
    m.run()
    assert m.istep == 2
    assert sorted(os.listdir(cfg.setup.restart_dir)) == [
        "ice.restart_file", "iced.2005-01-01-07200.nc"]
    st, cal = trestart.read_restart(cfg.setup.pointer_file, m.state)
    _assert_states_equal(st, m.state)
    assert cal == m.calendar


ABORTS = {
    "freshwater": ("hemispheric_budgets", RuntimeError,
                   "freshwater budget"),
    "nonfinite": ("check_state", FloatingPointError, "non-finite state"),
    "transport": ("model_step", RuntimeError, "departure points"),
}


@pytest.mark.parametrize("which", list(ABORTS))
def test_early_checkpoint_before_each_abort(which, monkeypatch, tmp_path):
    """Each of the three diagfreq aborts writes a restart of the offending
    state (and points the pointer file at it) before it raises."""
    cfg = _cfg("float32", tmp_path, **{"setup.diagfreq": 1,
                                       "setup.conserv_check": True})
    m = tdriver.Model(cfg, device="cpu")
    attr, exc, msg = ABORTS[which]
    if which == "freshwater":
        real = tdiag.hemispheric_budgets

        def fake(*a, **k):
            bud = real(*a, **k)
            bud["water_residual"] = bud["dM"] * 0.5 + 1e6
            return bud
        monkeypatch.setattr(tdiag, attr, fake)
    elif which == "nonfinite":
        real = tdiag.check_state

        def fake(*a, **k):
            return dict(real(*a, **k), nonfinite=torch.tensor(True))
        monkeypatch.setattr(tdiag, attr, fake)
    else:
        real = tdriver.model_step

        def fake(*a, **k):
            st, fl = real(*a, **k)
            tc = dict(fl.transport_checks, oob=torch.tensor(True))
            return st, fl.replace(transport_checks=tc)
        monkeypatch.setattr(tdriver, attr, fake)
    with pytest.raises(exc, match=msg) as err:
        m.step()
    assert "early checkpoint written" in str(err.value)
    path = _pointer(cfg.setup.pointer_file)
    assert path == os.path.join(cfg.setup.restart_dir,
                                "iced.2005-01-01-03600.npz")
    st, cal = trestart.read_restart(path, m.state)
    _assert_states_equal(st, m.state)
    assert cal.istep == 1 and cal == m.calendar


def _jax_state(state_np):
    """The JAX package's State holding the port's numpy arrays."""
    kw = {k: (v if k == "trcrn" else jnp.asarray(v))
          for k, v in state_np.items()}
    kw["trcrn"] = {k: jnp.asarray(v) for k, v in state_np["trcrn"].items()}
    return JState(**kw)


def _jax_leaves(jstate):
    import jax
    return [np.asarray(x) for x in jax.tree.leaves(jstate)]


def test_leaf_order_is_the_jax_tree_order(runs):
    """`state_leaves` gives the order `jax.tree.flatten` gives the JAX
    State, tested by flattening both, not by reading the order."""
    import jax
    m = runs["model"]
    snp = convert.state_to_numpy(m.state)
    jst = _jax_state(snp)
    paths = [jax.tree_util.keystr(p, simple=True, separator=".")
             for p, _ in jax.tree_util.tree_flatten_with_path(jst)[0]]
    assert paths == JAX_LEAF_NAMES
    for name, x, y in zip(paths, state_leaves(m.state), _jax_leaves(jst)):
        np.testing.assert_array_equal(x.numpy(), y, err_msg=name)
    assert state_leaves(m.state)[JAX_LEAF_NAMES.index("iceUmask")].dtype \
        == torch.bool


@pytest.mark.parametrize("fmt", FORMATS)
def test_jax_restart_loads_into_the_port(runs, fmt, tmp_path):
    if fmt == "hdf5":
        pytest.importorskip("h5py")
    m = runs["model"]
    jst = _jax_state(convert.state_to_numpy(m.state))
    jc = JCalendar(**dataclasses.asdict(m.calendar))
    ptr = str(tmp_path / "ptr")
    jrestart.write_restart(str(tmp_path), jst, jc, ptr, fmt=fmt)
    st, cal = trestart.read_restart(ptr, m.state)
    _assert_states_equal(st, m.state)
    assert dataclasses.astuple(cal) == dataclasses.astuple(jc)
    # and a Model continues from it
    cont = tdriver.Model(runs["cfg"].with_overrides(**{
        "setup.runtype": "continue", "setup.pointer_file": ptr}),
        device="cpu")
    _assert_states_equal(cont.state, m.state)
    assert cont.calendar == m.calendar


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_restart_loads_into_jax(runs, fmt, tmp_path):
    if fmt == "hdf5":
        pytest.importorskip("h5py")
    m = runs["model"]
    ptr = str(tmp_path / "ptr")
    path = trestart.write_restart(str(tmp_path), m.state, m.calendar, ptr,
                                  fmt=fmt)
    assert _pointer(ptr) == path
    template = _jax_state(convert.state_to_numpy(
        tdriver.Model(runs["cfg"], device="cpu").state))
    jst, jc = jrestart.read_restart(ptr, template)
    got = _jax_leaves(jst)
    for name, x, y in zip(JAX_LEAF_NAMES, state_leaves(m.state), got):
        assert x.numpy().dtype == y.dtype, name
        np.testing.assert_array_equal(x.numpy(), y, err_msg=name)
    assert dataclasses.astuple(jc) == dataclasses.astuple(m.calendar)


def test_read_restart_follows_the_template_device_and_dtype(runs, tmp_path):
    """Each leaf lands on the template's device in the template's dtype;
    a file whose leaves do not fit the state is refused."""
    m = runs["model"]
    ptr = str(tmp_path / "ptr")
    trestart.write_restart(str(tmp_path), m.state, m.calendar, ptr)
    other = "float64" if runs["dtype"] == "float32" else "float32"
    tmpl = tdriver.Model(_cfg(other, tmp_path), device="cpu").state
    st, _ = trestart.read_restart(ptr, tmpl)
    for x, y, t in zip(state_leaves(st), state_leaves(m.state),
                       state_leaves(tmpl)):
        assert x.dtype == t.dtype and x.device == t.device
        assert torch.equal(x, y.to(t.dtype))
    small = tdriver.Model(tconfig.gx1pop_step(24, 20), device="cpu").state
    with pytest.raises(ValueError, match="leaf_0 has shape"):
        trestart.read_restart(ptr, small)


def test_pio_and_io_async_raise_naming_the_roadmap(tmp_path, capsys):
    """Sharded restarts (ROADMAP A8) still raise. The background writer,
    the point probes and the debug dumps, which raised naming A7 until
    coupling and I/O were ported, now build a Model that steps."""
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tdriver.Model(_cfg("float32", tmp_path,
                           **{"setup.restart_format": "pio"}), device="cpu")
    m = tdriver.Model(_cfg("float32", tmp_path, **{"setup.io_async": True}),
                      device="cpu")
    assert m.io_writer is not None and m.io_writer.native
    m.run(1)
    path = m.write_restart()
    assert m.flush_io() == 0
    with open(m.cfg.setup.pointer_file) as f:
        assert f.read().strip() == path
    st, cal = trestart.read_restart(m.cfg.setup.pointer_file, m.state)
    _assert_states_equal(st, m.state)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        trestart.write_restart(str(tmp_path), m.state, m.calendar,
                               fmt="pio")
    with pytest.raises(ValueError, match="unknown restart format"):
        trestart.write_restart(str(tmp_path), m.state, m.calendar,
                               fmt="nc4")
    for over in ({"setup.print_points": True}, {"setup.debug_model": True}):
        m = tdriver.Model(_cfg("float32", tmp_path, **over,
                               **{"setup.diagfreq": 1}), device="cpu")
        m.step()
        assert np.isfinite(m.state.aice.numpy()).all()
        pts = m.diag_log[-1].get("points")
        assert (pts is not None) == over.get("setup.print_points", False)
    assert pts is None and len(m.points) == 2
    assert "debug_model step 1:" in capsys.readouterr().out
