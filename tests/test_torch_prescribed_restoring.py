"""Prescribed ice and restoring of the PyTorch port
(cice_tpu_torch/model/prescribed.py, restoring.py and their wiring in
Model.step) against the JAX package's.

Module functions run on the same numpy inputs, made from a seed (f64 to
1e-15 of each field's largest value, f32 to its rounding: the JAX package
under x64 computes the nudge in float64 and the port in the state's
dtype). Whole runs: two steps of a prescribed run (16x16 latlon, seasonal
forcing, kdyn=0, as tests/test_new_components.py runs it) against JAX's
Model in f64, with test_torch_step's tolerances; the bdyrestore pair
(a second JAX compile, against which the port's f32 run is held too) and
the f32 prescribed pair are in the slow tier. The
quick tier also holds the port's restoring step against `model_step` and
the nudge computed by hand, and shows that neither run aborts on the
freshwater residual that prescribing and nudging leave (no flux carries
the mass they add).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax.numpy as jnp  # noqa: E402

from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from cice_tpu.model import prescribed as jpres  # noqa: E402
from cice_tpu.model import restoring as jrest  # noqa: E402
from cice_tpu.model.driver import Model as JModel  # noqa: E402
from cice_tpu.model.step import ModelStatic as JStatic  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.calendar import Calendar  # noqa: E402
from cice_tpu_torch.config import Config  # noqa: E402
from cice_tpu_torch.core.grid import make_grid  # noqa: E402
from cice_tpu_torch.io import restart as trestart  # noqa: E402
from cice_tpu_torch.model import prescribed as tpres  # noqa: E402
from cice_tpu_torch.model import restoring as trest  # noqa: E402
from cice_tpu_torch.model.driver import Model  # noqa: E402
from cice_tpu_torch.model.state import state_leaves  # noqa: E402
from cice_tpu_torch.model.step import ModelStatic, model_step  # noqa: E402
import test_torch_step as ts  # noqa: E402
from test_torch_restart import _jax_state  # noqa: E402

BASE = {"grid.nx_global": 16, "grid.ny_global": 16,
        "grid.grid_format": "latlon", "forcing.atm_data_type": "seasonal",
        "thermo.nit": 3, "setup.conserv_check": True, "setup.diagfreq": 1}
PRESCRIBED = {"setup.prescribed_ice": True, "dynamics.kdyn": 0}
BDYRESTORE = {"forcing.restore_ice": True, "forcing.restore_ocn": True,
              "forcing.trestore": 3}


def _cfgs(dtype, **over):
    o = dict(BASE, dtype=dtype, **over)
    return Config().with_overrides(**o), JConfig().with_overrides(**o)


def _perturbed(m, seed):
    """The model's state with random ice in every ocean cell, from `seed`:
    a state unlike the initial one, for nudging toward the initial one."""
    rng = np.random.default_rng(seed)
    d = convert.state_to_numpy(m.state)
    hm = m.grid.hm.numpy()
    for k in ("aicen", "vicen", "vsnon"):
        d[k] = (d[k] + 0.02 * rng.random(d[k].shape) * hm).astype(
            d[k].dtype)
    for k, v in d["trcrn"].items():
        d["trcrn"][k] = (v * (1.0 + 0.01 * rng.standard_normal(v.shape))
                         ).astype(v.dtype)
    d["sst"] = (d["sst"] + rng.standard_normal(d["sst"].shape)).astype(
        d["sst"].dtype)
    return d


def _close(got, ref, dtype, what):
    got, ref = np.asarray(got), np.asarray(ref, dtype=got.dtype)
    rtol = 1e-15 if dtype == "float64" else 2 * np.finfo(np.float32).eps
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale,
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_module_functions_match_jax(dtype):
    tcfg, jcfg = _cfgs(dtype, **{"grid.ew_boundary_type": "closed",
                                 "grid.ns_boundary_type": "open"})
    m = Model(tcfg, device="cpu")
    jgrid = jmake_grid(jcfg)
    d = _perturbed(m, 1)
    tst, jst = convert.state_from_numpy(d, "cpu"), _jax_state(d)
    dt = tcfg.setup.dt

    # the zone: 3 rows at the open edges, 3 columns at the closed ones
    zone = trest.boundary_zone_weight(m.grid)
    _close(zone.numpy(), jrest.boundary_zone_weight(jgrid), dtype, "zone")
    assert float(zone.max()) == 1.0 and float(zone[5:-5, 5:-5].max()) == 0

    # restore_ice toward the initial state, restore_sst toward data
    t_tgt = trest.make_restore_target(tcfg, m.state)
    j_tgt = jrest.make_restore_target(jcfg, _jax_state(
        convert.state_to_numpy(m.state)))
    got = trest.restore_ice(tcfg, m.grid, tst, t_tgt, dt)
    ref = jrest.restore_ice(jcfg, jgrid, jst, j_tgt, dt)
    for k in ("aicen", "vicen", "vsnon"):
        _close(getattr(got, k).numpy(), getattr(ref, k), dtype, k)
    for k in got.trcrn:
        _close(got.trcrn[k].numpy(), ref.trcrn[k], dtype, k)
    sst_data = np.full(d["sst"].shape, -1.5, d["sst"].dtype)
    for tres in (3, 0):
        c_t, c_j = _cfgs(dtype, **{"forcing.trestore": tres})
        _close(trest.restore_sst(c_t, tst, torch.as_tensor(sst_data),
                                 dt).sst.numpy(),
               jrest.restore_sst(c_j, jst, jnp.asarray(sst_data), dt).sst,
               dtype, f"sst trestore={tres}")

    # prescribe_ice_state on data with new and persisting ice
    rng = np.random.default_rng(2)
    data = np.where(rng.random(d["sst"].shape) < 0.5, rng.random(
        d["sst"].shape), 0.0)
    hin_max = ModelStatic.build(tcfg).hin_max
    got = tpres.prescribe_ice_state(tcfg, m.grid, tst, data, hin_max)
    ref = jpres.prescribe_ice_state(jcfg, jgrid, jst, jnp.asarray(data),
                                    JStatic.build(jcfg).hin_max)
    for k in ("aicen", "vicen", "vsnon", "uvel", "vvel"):
        _close(getattr(got, k).numpy(), getattr(ref, k), dtype, k)
    for k in got.trcrn:
        _close(got.trcrn[k].numpy(), ref.trcrn[k], dtype, k)
    assert got.aicen.dtype == tst.aicen.dtype


def test_prescribed_cover_matches_the_jax_driver(tmp_path):
    """The seasonal cap without a dataset, and the month's plane of an
    ice_cov.npz in atm_data_dir (months cycle), as the JAX driver's
    `_prescribed_aice` gives them."""
    tcfg, jcfg = _cfgs("float64", **PRESCRIBED)
    grid = make_grid(tcfg, "cpu")
    jm = JModel(jcfg)
    for day in (1, 80, 200):
        cal = Calendar(year=2005, month=1, day=1).advance(86400.0 *
                                                          (day - 1))
        jm.calendar = jm.calendar.__class__(year=cal.year, month=cal.month,
                                            day=cal.day)
        np.testing.assert_array_equal(
            tpres.prescribed_aice(grid, cal).numpy(),
            np.asarray(jm._prescribed_aice(None)), err_msg=f"day {day}")
    cov = np.random.default_rng(4).random((3, 16, 16))
    np.savez(tmp_path / "ice_cov.npz", ice_cov=cov)
    over = {**PRESCRIBED, "forcing.atm_data_dir": str(tmp_path)}
    tcfg, jcfg = _cfgs("float64", **over)
    jm = JModel(jcfg)
    np.testing.assert_array_equal(tpres.load_ice_cov(tcfg), cov)
    for month in (1, 2, 5):
        cal = Calendar(year=2005, month=month, day=3)
        jm.calendar = cal.__class__(year=2005, month=month, day=3)
        np.testing.assert_array_equal(
            tpres.prescribed_aice(grid, cal, torch.as_tensor(cov)).numpy(),
            np.asarray(jm._prescribed_aice(None)))


def test_ice_data_file_from_a_port_restart(tmp_path):
    """forcing.ice_data_file names a restart the port wrote: both packages
    read the same target from it."""
    tcfg, jcfg = _cfgs("float64")
    m = Model(tcfg, device="cpu")
    d = _perturbed(m, 5)
    path = trestart.write_restart(str(tmp_path), convert.state_from_numpy(
        d, "cpu"), m.calendar, fmt="cdf1")
    over = {"forcing.ice_data_file": path}
    t_tgt = trest.make_restore_target(Config().with_overrides(
        **dict(BASE, dtype="float64", **over)), m.state)
    j_tgt = jrest.make_restore_target(JConfig().with_overrides(
        **dict(BASE, dtype="float64", **over)),
        _jax_state(convert.state_to_numpy(m.state)))
    for k in ("aicen", "vicen", "vsnon"):
        np.testing.assert_array_equal(t_tgt[k].numpy(), d[k])
        np.testing.assert_array_equal(t_tgt[k].numpy(), j_tgt[k])
    for k, v in t_tgt["trcrn"].items():
        np.testing.assert_array_equal(v.numpy(), j_tgt["trcrn"][k])
    # the target is a copy: stepping the model leaves it as it was
    before = [t.clone() for t in state_leaves(m.state)]
    tgt = trest.make_restore_target(tcfg, m.state)
    m.run(1)
    assert torch.equal(tgt["aicen"], before[0])


def _run_pair(dtype, over, steps=2, jax_dtype=None):
    """`steps` steps of the port in `dtype` against the JAX package's Model
    in `jax_dtype` (default the same), compared at `dtype`'s tolerance."""
    tcfg, _ = _cfgs(dtype, **over)
    _, jcfg = _cfgs(jax_dtype or dtype, **over)
    tm, jm = Model(tcfg, device="cpu"), JModel(jcfg)
    for step in range(steps):
        tm.step()
        jm.step()
        ts._compare(convert.state_to_numpy(tm.state), ts._tree(jm.state),
                    f"{dtype} step {step + 1} state", dtype)
        ts._compare(convert.fluxout_to_numpy(tm.flux), ts._tree(jm.flux),
                    f"{dtype} step {step + 1} flux", dtype)
    return tm, jm


def test_prescribed_run_matches_jax_f64():
    tm, jm = _run_pair("float64", PRESCRIBED)
    lat = tm.grid.TLAT.numpy()
    polar = (lat > np.deg2rad(70.0)) & (tm.grid.hm.numpy() > 0.5)
    assert polar.sum() > 0
    # the prescribed 0.95, changed little by the step's thermodynamics
    assert np.all(np.abs(tm.state.aice.numpy()[polar] - 0.95) < 0.05)
    assert len(tm.diag_log) == 2 and len(jm.diag_log) == 2


OPEN_BDYRESTORE = dict(BDYRESTORE, **{"grid.ew_boundary_type": "open"})


@pytest.mark.slow
@pytest.mark.parametrize("dtype,jax_dtype,over", [
    ("float64", "float64", OPEN_BDYRESTORE),
    ("float32", "float64", OPEN_BDYRESTORE),
    ("float32", "float32", PRESCRIBED)],
    ids=["bdyrestore-f64", "bdyrestore-f32", "prescribed-f32"])
def test_runs_match_jax_slow(monkeypatch, dtype, jax_dtype, over):
    """The bdyrestore pair with dynamics, and the f32 runs. In this
    configuration the midwinter ponds are rounding residue that grows to
    ~2e-7 in two steps, with or without restoring, and the port's and the
    reference's residues differ by their whole size: apnd and hpnd take a
    floor of 1e-6. The JAX package's f32 bdyrestore run cannot be the
    reference: under x64 its restore_ice computes in float64 and promotes
    the float32 state, and its own transport check then aborts; the port's
    f32 run is held against its f64 run at the f32 tolerance."""
    for k in ("apnd", "hpnd"):
        monkeypatch.setitem(ts.FLOORS, k, (1e-6, 1e-3))
    _run_pair(dtype, over, jax_dtype=jax_dtype)


def test_restoring_step_is_model_step_then_the_nudge():
    """Model.step with bdyrestore = model_step, then each zone cell moves
    by zone * dt/trestore of its gap to the target and the SST by
    dt/trestore of its gap to sst_data; cells outside the zone keep
    model_step's values bit for bit."""
    tcfg, _ = _cfgs("float64", **BDYRESTORE, **{
        "grid.ew_boundary_type": "open", "setup.diagfreq": 0})
    m = Model(tcfg, device="cpu")
    d = _perturbed(m, 3)
    m.state = convert.state_from_numpy(d, "cpu")
    target = m._restore_target
    fc = m._forcing()
    plain, _ = model_step(m.static, m.grid, m.state, fc, tcfg.setup.dt)
    m.step()
    rate = tcfg.setup.dt / (3 * 86400.0)
    zone = trest.boundary_zone_weight(m.grid)
    inside = zone > 0
    for k in ("aicen", "vicen", "vsnon"):
        p, t, got = getattr(plain, k), target[k], getattr(m.state, k)
        want = p + rate * zone * (t - p)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert torch.equal(got[:, ~inside], p[:, ~inside])
        assert float((got - p)[:, inside].abs().max()) > 0
    torch.testing.assert_close(
        m.state.sst, plain.sst + rate * (fc.sst_data - plain.sst),
        rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["prescribed", "bdyrestore"])
def test_no_false_budget_abort(tmp_path, kind):
    """The freshwater residual of a nudged run exceeds the 1 % of the
    budget that aborts an ordinary run (Model._diagnose); the nudged run
    records it and goes on. The bdyrestore run replaces its zone outright
    (trestore=0) with a target that holds half the ice
    (forcing.ice_data_file)."""
    io = {"setup.restart_dir": str(tmp_path / "r"),
          "setup.pointer_file": str(tmp_path / "r" / "pointer")}
    if kind == "prescribed":
        over = PRESCRIBED
    else:
        m = Model(_cfgs("float64")[0], device="cpu")
        half = m.state.replace(**{k: 0.5 * getattr(m.state, k)
                                  for k in ("aicen", "vicen", "vsnon")})
        path = trestart.write_restart(str(tmp_path), half, m.calendar)
        over = dict(BDYRESTORE, **{"forcing.trestore": 0,
                                   "forcing.ice_data_file": path})
    m = Model(_cfgs("float64", **over, **io)[0], device="cpu")
    m.run(2)
    assert m.calendar.istep == 2 and len(m.diag_log) == 2
    assert not os.path.exists(tmp_path / "r" / "pointer")  # no early dump
    worst = max(abs(r["bud_water_residual"]) /
                max(abs(r["bud_dM"]), abs(r["bud_water_in"]), 1.0)
                for r in m.diag_log)
    assert worst > 1e-2
