"""PyTorch port vs JAX package: the biogeochemistry as a whole. Two coupled
steps (Model.step) of the gx1pop_step configuration on the 48x40
displaced-pole POP grid (tests/test_torch_column_steps.py's harness), with
history, against the JAX package's model_step:

- `bgcz`: the brine height tracer and the vertical z tracers on a 7-layer
  bio grid (16 tracers, each with its mobile fraction and snow reservoir:
  266 flat transport entries, 226 of them riding vice -> fbri);
- `bgcskl`: the skeletal-layer algae and nitrate.

tests/test_torch_aero_iso.py steps `modal` (aerosols with modal optics in
delta-Eddington) the same way; tests/test_torch_step.py holds step_therm1
with each option alone (aerosols, isotopes, the brine tracer, highfreq,
dEdd_algae). The slow tier here adds `aerosol`, `isotope` and `highfreq`
in f64 and all five sets in f32.

Also here: the history groups' registration in the JAX package's order for
bgcskl, bgcz, zaero, aerosol and isotope; the streams after the steps;
restarts of a bgcz state (4-D z tracers, their _mf and _sn companions)
across the packages in npz, cdf1 and hdf5; and a resumed bgcz run that
equals the uninterrupted one bit for bit.

Tolerances: test_torch_column_steps.py's: f64 rtol 1e-8 of each field's
largest value with test_torch_step.py's absolute FLOORS, or 50 times the
JAX package's own envelope (how far its result moves when vicen moves by
1e-15), whichever is larger; f32 rtol 2e-3 and the envelope of a 2e-7
perturbation. The box2001 forcing is midwinter: no shortwave reaches the
algae, so these steps hold the transport, exchange, mortality and
remineralisation of the network; the module tests hold its growth in
light.
"""

import argparse
import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

from cice_tpu.calendar import Calendar as JCalendar  # noqa: E402
from cice_tpu.cli import main as jcli  # noqa: E402
from cice_tpu.io import history as jhist  # noqa: E402
from cice_tpu.io import restart as jrestart  # noqa: E402
from cice_tpu.model import diagnostics as jdiag  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.cli import main as tcli  # noqa: E402
from cice_tpu_torch.io import history_fields as tfields  # noqa: E402
from cice_tpu_torch.io import restart as trestart  # noqa: E402
from cice_tpu_torch.model import diagnostics as tdiag  # noqa: E402
from cice_tpu_torch.model import driver as tdriver  # noqa: E402
from cice_tpu_torch.model.state import state_leaves  # noqa: E402
import test_torch_column_steps as tcs  # noqa: E402
import test_torch_history as th  # noqa: E402
import test_torch_step as ts  # noqa: E402
from test_torch_restart import _jax_leaves, _jax_state  # noqa: E402

OPTS = {name: dict(tcli.OPTION_SETS[name])
        for name in ("bgcz", "bgcskl", "aerosol", "isotope", "modal")}
OPTS["highfreq"] = {"forcing.highfreq": True}
SETS = ("bgcz", "bgcskl")
SLOW_F64 = ("aerosol", "isotope", "highfreq")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {name: tcs._run_pair(name, "float64",
                                tmp_path_factory.mktemp(name), OPTS[name])
            for name in SETS}


def _assert_bgc_active(run):
    """The option's tracers moved in the JAX reference and the port."""
    name = run["name"]
    st0 = ts._tree(convert.state_to_numpy(
        tdriver.Model(run["tcfg"], device="cpu").state))
    st, fl = run["ref"][-1]
    got = run["got"][-1][0]
    if name == "bgcz":
        # (the snow reservoirs stay empty: only z aerosols are deposited)
        for k in ("trcrn.fbri", "trcrn.bgc_Nit", "trcrn.bgc_N_mf",
                  "trcrn.bgc_DOC1"):
            assert not np.array_equal(st[k], st0[k]), k
        assert float(np.abs(fl["ncat_fluxes.fzbgc_bgc_Nit"]).max()) > 0.0
        assert float(fl["ncat_fluxes.bphizn"].max()) > 0.0
        assert got["trcrn.bgc_N"].shape[1] == 7
    elif name == "bgcskl":
        assert not np.array_equal(st["trcrn.bgc_Nit"], st0["trcrn.bgc_Nit"])
        assert float(np.abs(fl["ncat_fluxes.fbgc_Nit"]).max()) > 0.0
    elif name in ("aerosol", "modal"):
        assert float(st["trcrn.aerosno"].max()) > \
            float(st0["trcrn.aerosno"].max())
    elif name == "isotope":
        # box2001 has no snowfall to deposit isotopes: the burdens stay 0
        # (tests/test_torch_aero_iso.py deposits them)
        assert "ncat_fluxes.fiso_ocn" in fl
        assert st["trcrn.isosno"].shape == st0["trcrn.isosno"].shape
    assert float(np.abs(st["uvel"]).max()) > 1e-3             # ice moves


@pytest.mark.parametrize("name", SETS)
def test_two_steps_match_jax_f64(runs, name):
    tcs._check_steps(runs[name])
    _assert_bgc_active(runs[name])


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW_F64)
def test_other_sets_two_steps_match_jax_f64(name, tmp_path):
    run = tcs._run_pair(name, "float64", tmp_path, OPTS[name])
    tcs._check_steps(run)
    _assert_bgc_active(run)


@pytest.mark.slow
@pytest.mark.parametrize("name", SETS + SLOW_F64 + ("modal",))
def test_two_steps_match_jax_f32(name, tmp_path):
    tcs._check_steps(tcs._run_pair(name, "float32", tmp_path, OPTS[name]))


@pytest.mark.parametrize("opts", ["bgcskl", "bgcz", "zaero", "aerosol",
                                  "isotope", "bgcskl,bgcz"])
def test_history_groups_register_in_jax_order(opts):
    """The bgc, zbgc, hbrine and aero_iso groups: names, units, dimensions
    and rows in the JAX package's order (both networks at once share
    family names, first registration wins in both)."""
    over = {}
    for o in opts.split(","):
        over.update(jcli.OPTION_SETS[o])
    tcfg, jcfg = tcs._cfgs("float64", "/nonexistent", over)
    got = th._registry(tfields.build_fields(tcfg), tfields.nrows)
    ref = th._registry(jhist.build_fields(jcfg), jhist._nrows)
    assert got == ref


@pytest.mark.parametrize("name", SETS)
def test_history_stream_matches_jax(runs, name):
    """The daily stream after the two steps, every field against the JAX
    stream within the envelope of the perturbed JAX run's stream."""
    run = runs[name]
    tstream = run["tm"].history.streams[0]
    jstream = run["jm"].history.streams[0]
    assert [f.name for f in tstream.fields] == \
        [f.name for f in jstream.fields]
    got = th._stream_np(run["tm"].history, tstream)
    ref = th._stream_np(run["jm"].history, jstream)
    env = th._stream_np(run["jenv"].history, run["jenv"].history.streams[0])
    groups = {"bgcz": ("algalN_net001", "Nit_net", "bgc_N001", "bphizn",
                       "fNit", "hbrine", "fbrine", "Nit_frac"),
              "bgcskl": ("algal_N001", "Nit", "Nit_net", "fNit",
                         "ml_Nit")}[name]
    assert set(groups) <= set(ref)
    for k in ref:
        scale = float(np.abs(ref[k]).max())
        atol = max(ts.RTOL["float64"] * scale, th.FLOORS.get(k, 0.0),
                   tcs.ENVELOPE * float(np.abs(env[k] - ref[k]).max()))
        np.testing.assert_allclose(got[k], ref[k], rtol=ts.RTOL["float64"],
                                   atol=atol, err_msg=f"{name}: {k}")
    zero = [k for k in groups if float(np.abs(ref[k]).max()) == 0.0]
    assert not zero, zero


def test_bgc_and_hbrine_diags_match_jax(runs):
    """bgc_diags on the skeletal state and hbrine_diags on the bgcz state
    against the JAX package's on the same arrays (rtol 1e-12: reductions
    of a few thousand cells). On the z tracers the JAX package's bgc_diags
    multiplies (ncat, nblyr, ny, nx) by aicen and fails (ncat=5, nblyr=7);
    the port counts their layer mean."""
    def close(got, ref):
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                       rtol=1e-12, err_msg=k)
    for name, fn, jfn in (("bgcskl", tdiag.bgc_diags, jdiag.bgc_diags),
                          ("bgcz", tdiag.hbrine_diags, jdiag.hbrine_diags)):
        m, jm = runs[name]["tm"], runs[name]["jm"]
        got = fn(m.grid, m.state)
        ref = jfn(jm.grid, _jax_state(convert.state_to_numpy(m.state)))
        assert got
        close(got, ref)
    m = runs["bgcz"]["tm"]
    d = tdiag.bgc_diags(m.grid, m.state)
    w = (m.grid.tarea * m.grid.hm).numpy()
    nit = (m.state.trcrn["bgc_Nit"].mean(1) * m.state.aicen).sum(0).numpy()
    np.testing.assert_allclose(float(d["bgc_Nit_tot"]), (nit * w).sum(),
                               rtol=1e-12)
    with pytest.raises(Exception):
        jdiag.bgc_diags(runs["bgcz"]["jm"].grid,
                        _jax_state(convert.state_to_numpy(m.state)))


@pytest.mark.parametrize("fmt", ["npz", "cdf1", "hdf5"])
def test_bgcz_restart_crosses_between_packages(runs, fmt, tmp_path):
    """The bgcz state (4-D z tracers, their _mf and _sn companions, fbri)
    written by the port and read by the JAX package, and written by the
    JAX package and read by the port, bit for bit."""
    if fmt == "hdf5":
        pytest.importorskip("h5py")
    m = runs["bgcz"]["tm"]
    assert {"fbri", "bgc_N", "bgc_N_mf", "bgc_N_sn", "bgc_Fep"} <= \
        set(m.state.trcrn)
    ptr = str(tmp_path / "ptr_port")
    trestart.write_restart(str(tmp_path / "port"), m.state, m.calendar, ptr,
                           fmt=fmt)
    template = _jax_state(convert.state_to_numpy(m.state))
    jst, jc = jrestart.read_restart(ptr, template)
    for x, y in zip(state_leaves(m.state), _jax_leaves(jst)):
        np.testing.assert_array_equal(x.numpy(), y)
    assert dataclasses.astuple(jc) == dataclasses.astuple(m.calendar)
    ptr = str(tmp_path / "ptr_jax")
    jrestart.write_restart(str(tmp_path / "jax"), template,
                           JCalendar(**dataclasses.asdict(m.calendar)), ptr,
                           fmt=fmt)
    st, _ = trestart.read_restart(ptr, m.state)
    for x, y in zip(state_leaves(st), state_leaves(m.state)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bgcz_continued_run_equals_uninterrupted_bit_for_bit(dtype,
                                                             tmp_path):
    """A bgcz run dumps npz at step 2 (dumpfreq='1', dumpfreq_n=2); a fresh
    Model continues from the dump for 2 more steps and equals the
    uninterrupted 4-step run in every leaf."""
    root = str(tmp_path)
    cfg = tcli.build_config(argparse.Namespace(
        opts="box2001,bgcz", set=["grid.nx_global=12", "grid.ny_global=10",
                                  "dynamics.ndte=10"])).with_overrides(**{
        "dtype": dtype, "setup.dumpfreq": "1", "setup.dumpfreq_n": 2,
        "setup.restart_dir": os.path.join(root, "restart"),
        "setup.pointer_file": os.path.join(root, "restart",
                                           "ice.restart_file")})
    a = tdriver.Model(cfg, device="cpu")
    a.run(2)
    ptr = shutil.copy(cfg.setup.pointer_file, os.path.join(root, "ptr2"))
    a.run(2)
    cont = os.path.join(root, "cont")
    os.makedirs(cont)
    b = tdriver.Model(cfg.with_overrides(**{
        "setup.runtype": "continue",
        "setup.pointer_file": shutil.copy(ptr, os.path.join(cont, "ptr")),
        "setup.restart_dir": cont}), device="cpu")
    assert b.istep == 2
    b.run(2)
    la, lb = state_leaves(a.state), state_leaves(b.state)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert b.calendar == a.calendar
