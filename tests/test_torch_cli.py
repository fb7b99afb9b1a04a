"""The port's CLI (cice_tpu_torch.cli) against the JAX package's: the
option-set table, composition of --opts and --set, "{FIX}" resolution to
the port's own fixture root, compare_series on the committed r05 series,
the unknown-option message, a smoke test and a restart test on the CPU,
and the commands of the coupling and I/O slice: case, suite (the JAX
package's table; the decomp suite's rows pass on 8 spawned gloo ranks),
perf (on the CPU, on one rank and on two spawned ranks), qc against the JAX
package's on the same arrays and history files, and the plots; `python -m
cice_tpu_torch`, `run --profile`, and the option sets evpwide, iopio and
iopio2 on the CPU, with the io suite's iopio row."""

import argparse
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

from cice_tpu.cli import main as jcli  # noqa: E402
from cice_tpu_torch.cli import main as tcli  # noqa: E402
from cice_tpu_torch.io import fixtures as tfix  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R05 = os.path.join(ROOT, "baselines", "r05")


def _args(opts="", sets=None, **kw):
    return argparse.Namespace(opts=opts, set=sets, **kw)


def test_option_sets_are_the_jax_table():
    assert tcli.OPTION_SETS == jcli.OPTION_SETS


@pytest.mark.parametrize("opts,sets", [
    ("gx1pop,evp1d", None),
    ("tx1pop,day1", ["dynamics.ndte=60", "setup.diagfreq=3"]),
    ("box2001,dynpicard,run2day", ["grid.nx_global=40"]),
    ("gx3pop,precision8,histinst", ["forcing.precip_units=mm_per_day"])])
def test_composition_and_fixture_root(monkeypatch, tmp_path, opts, sets):
    """Comma-composed option sets then --set pairs, in order, with "{FIX}"
    resolved to $CICE_TPU_TORCH_FIXTURES (the fixtures are not written
    here: the writers have their own tests)."""
    monkeypatch.setenv("CICE_TPU_TORCH_FIXTURES", str(tmp_path / "t"))
    monkeypatch.setenv("CICE_TPU_FIXTURES", str(tmp_path / "j"))
    written = []
    monkeypatch.setattr(tfix, "ensure_baseline_fixtures",
                        lambda: written.append(1))
    monkeypatch.setattr(jcli, "_resolve_fixtures", lambda o: {
        k: v.replace("{FIX}", str(tmp_path / "t")) if isinstance(v, str)
        else v for k, v in o.items()})
    got = tcli.build_config(_args(opts, sets))
    ref = jcli.build_config(_args(opts, sets))
    for group in ("grid", "forcing", "dynamics", "setup", "thermo"):
        assert getattr(got, group).__dict__ == getattr(ref, group).__dict__, \
            group
    assert got.dtype == ref.dtype
    if "pop" in opts:
        assert written and got.grid.grid_file.startswith(str(tmp_path / "t"))
        assert os.path.basename(got.grid.grid_file).endswith("_grid.bin")


def test_unknown_option_set_exits_with_the_jax_message():
    with pytest.raises(SystemExit) as t:
        tcli.build_config(_args("box2001,nosuchset"))
    with pytest.raises(SystemExit) as j:
        jcli.build_config(_args("box2001,nosuchset"))
    assert str(t.value) == str(j.value)
    assert str(t.value).startswith("unknown option set 'nosuchset'")


@pytest.mark.parametrize("label", ["gx1pop", "gx3pop", "tx1pop"])
def test_compare_series_on_the_r05_baselines(label):
    with open(os.path.join(R05, f"{label}.json")) as f:
        a = json.load(f)["series"]
    with open(os.path.join(R05, "gx1pop+gridc.json")) as f:
        b = json.load(f)["series"]
    pert = [{k: v * (1.0 + 2e-3 * ((i + len(k)) % 3 == 0))
             for k, v in r.items()} for i, r in enumerate(a)]
    for x, y in ((a, a), (a, pert), (a, b), (a[:-1], a)):
        for rtol in (0.0, 1e-3, 1e-2):
            assert tcli.compare_series(x, y, rtol) == \
                jcli.compare_series(x, y, rtol)
    assert tcli.compare_series(a, pert, 1e-3)
    rel = tcli.largest_rel_deltas(a, pert)
    assert set(rel) == set(a[0])
    assert 1.9e-3 < max(rel.values()) < 2.1e-3


def test_smoke_and_restart_tests_pass_on_the_cpu(capsys):
    for kind in ("smoke", "restart"):
        rc = tcli.main(["test", "--type", kind, "--device", "cpu",
                        "--set", "grid.nx_global=12",
                        "--set", "grid.ny_global=10"])
        assert rc == 0, capsys.readouterr().out
        assert f"PASS test_{kind}" in capsys.readouterr().out


def test_bgen_then_bcmp_of_the_series(tmp_path, capsys):
    common = ["test", "--type", "smoke", "--device", "cpu", "--opts",
              "hours3", "--set", "grid.nx_global=12",
              "--set", "grid.ny_global=10"]
    assert tcli.main(common + ["--bgen", str(tmp_path)]) == 0
    assert os.path.exists(tmp_path / "smoke_hours3.json")
    assert tcli.main(common + ["--bcmp", str(tmp_path)]) == 0
    assert "PASS bcmp_smoke" in capsys.readouterr().out


@pytest.mark.parametrize("opts", ["gridc", "gridcd", "dynpicard",
                                  "dynanderson", "eap", "upwind", "vanleer",
                                  "gridc,upwind"])
def test_dynamics_and_transport_option_sets_run_through_the_cli(opts,
                                                                capsys):
    """The C/CD-grid, VP, EAP and other-transport option sets step on the
    CPU through `cli run` (box2001 at 12x10, VP counts cut)."""
    rc = tcli.main(["run", "--device", "cpu", "--opts", f"box2001,{opts}",
                    "--steps", "2", "--set", "grid.nx_global=12",
                    "--set", "grid.ny_global=10", "--set", "dynamics.ndte=10",
                    "--set", "dynamics.maxits_nonlin=2",
                    "--set", "dynamics.dim_fgmres=5",
                    "--set", "dynamics.maxits_fgmres=5"])
    assert rc == 0, capsys.readouterr().out


def test_unported_option_sets_raise_naming_the_roadmap():
    """No option set raises any more. `evpwide` and `gridc,evpwide`, which
    raised naming A8 until the wide-halo EVP was ported, build a Model
    that steps (one process has no mesh: the one-program solve, as in the
    JAX package; parallel/evp_wide.py); `Mesh.shard_state`, which named
    A8 until the state could be sharded, gives the tiles of a 1x1 mesh:
    copies of the whole leaves. `ioasync` (the background writer), which
    raised naming A7 until coupling and I/O were ported, builds a Model
    that steps, and so
    does `modal` (aerosols with modal optics in dEdd), which raised until
    the biogeochemistry was ported."""
    from cice_tpu_torch.model.driver import Model
    from cice_tpu_torch.parallel.mesh import Mesh
    for opts in ("evpwide", "gridc,evpwide"):
        cfg = tcli._default_test_cfg(_args(opts, type="smoke"),
                                     tcli.build_config(_args(opts)))
        m = Model(cfg.with_overrides(**{"grid.nx_global": 12,
                                        "grid.ny_global": 10}), device="cpu")
        assert m.cfg.dynamics.evp_algorithm == "wide_halo"
        m.run(1)
        assert np.isfinite(m.state.aice.numpy()).all()
    from cice_tpu_torch.model.state import state_leaves
    tiles = Mesh().shard_state(m.state)
    for a, b in zip(state_leaves(tiles), state_leaves(m.state)):
        assert torch.equal(a, b)
        assert a.ndim < 2 or a.data_ptr() != b.data_ptr()
    cfg = tcli._default_test_cfg(_args("ioasync", type="smoke"),
                                 tcli.build_config(_args("ioasync")))
    m = Model(cfg.with_overrides(**{"grid.nx_global": 12,
                                    "grid.ny_global": 10}), device="cpu")
    assert m.io_writer is not None
    m.run(1)
    assert m.calendar.istep == 1 and m.flush_io() == 0
    cfg = tcli._default_test_cfg(_args("modal", type="smoke"),
                                 tcli.build_config(_args("modal")))
    m = Model(cfg, device="cpu")
    assert {"aerosno", "aeroice"} <= set(m.state.trcrn)
    assert m.cfg.shortwave.modal_aero


@pytest.mark.parametrize("opts", ["modal", "bgcskl", "bgcz", "zaero",
                                  "isotope", "aerosol", "alt03", "alt04"])
def test_biogeochemistry_option_sets_run_through_the_cli(opts, capsys):
    """Each biogeochemical option set of the JAX package's table steps on
    the CPU through `cli run` (box2001 at 12x10)."""
    rc = tcli.main(["run", "--device", "cpu", "--opts", f"box2001,{opts}",
                    "--steps", "2", "--set", "grid.nx_global=12",
                    "--set", "grid.ny_global=10",
                    "--set", "dynamics.ndte=10"])
    assert rc == 0, capsys.readouterr().out


def test_cli_smoke_test_of_bgcz(capsys):
    rc = tcli.main(["test", "--type", "smoke", "--opts", "bgcz",
                    "--device", "cpu", "--set", "grid.nx_global=12",
                    "--set", "grid.ny_global=10"])
    assert rc == 0, capsys.readouterr().out
    assert "PASS test_smoke" in capsys.readouterr().out

# -- the commands ported with coupling and I/O --------------------------------

def test_suite_table_is_the_jax_table():
    assert tcli.SUITES == jcli.SUITES


def test_case_writes_a_runner_that_runs(tmp_path, capsys):
    import subprocess
    import sys
    d = tmp_path / "case"
    rc = tcli.main(["case", "--dir", str(d), "--device", "cpu", "--opts",
                    "gbox12", "--set", "setup.npt=2",
                    "--set", 'setup.npt_unit="1"',
                    "--set", 'setup.histfreq=["1", "x", "x", "x", "x"]',
                    "--set", f"setup.history_dir={tmp_path}/h"])
    assert rc == 0 and "case created" in capsys.readouterr().out
    with open(d / "config.json") as f:
        over = json.load(f)
    assert over["grid.nx_global"] == 12 and over["setup.npt"] == 2
    with open(d / "run.py") as f:
        src = f.read()
    assert "cice_tpu_torch" in src and "device='cpu'" in src
    assert "import jax" not in src and "from cice_tpu." not in src
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(d / "run.py")], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done at 2005-01-01-07200" in r.stdout
    assert len(os.listdir(tmp_path / "h")) == 2     # hourly history


def test_case_runner_defaults_to_the_card(tmp_path):
    tcli.main(["case", "--dir", str(tmp_path), "--opts", "gbox12"])
    with open(tmp_path / "run.py") as f:
        assert "device='cuda'" in f.read()


def test_suite_quick_on_a_small_grid(capsys):
    rc = tcli.main(["suite", "--name", "quick", "--device", "cpu",
                    "--set", "grid.nx_global=12",
                    "--set", "grid.ny_global=10"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "2/2 passed" in out


def test_a_suite_row_that_needs_a8_fails_and_the_suite_exits_1(capsys):
    """The decomp suite's rows, which needed ROADMAP A8 and failed until
    the state could be sharded, pass: 2 steps on 2x4 and on 4x2 spawned
    gloo ranks equal 2 steps of one process (largest deviation 0.0)."""
    rc = tcli.main(["suite", "--name", "decomp", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "2/2 passed" in out, out
    assert out.count("PASS test_decomp") == 2
    assert out.count("largest deviation 0.0 of the field's scale") == 4


def test_restart_test_through_the_background_writer(capsys):
    rc = tcli.main(["test", "--type", "restart", "--opts", "ioasync",
                    "--device", "cpu", "--set", "grid.nx_global=12",
                    "--set", "grid.ny_global=10"])
    assert rc == 0 and "PASS test_restart" in capsys.readouterr().out


def test_perf_on_the_cpu_and_the_mesh_refusal(capsys):
    rc = tcli.main(["perf", "--device", "cpu", "--sizes", "12x10,24x20",
                    "--ndte", "4", "--weak-tile", "8x8"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert rc == 0 and [r["sweep"] for r in rows] == ["sizes", "sizes",
                                                      "strong", "weak"]
    assert [r["grid"] for r in rows] == ["12x10", "24x20", "24x20", "8x8"]
    assert all(r["route"] == "plain" and r["device"] == "cpu" and
               r["Mptsub_s"] > 0 for r in rows)
    # two ranks: the JAX package's two rows per sweep, on gloo, no card
    rc = tcli.main(["perf", "--device", "cpu", "--sizes", "12x10,24x20",
                    "--ndte", "4", "--weak-tile", "8x8", "--mesh", "1,2"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    two = [r for r in rows if r["devices"] == 2]
    assert rc == 0 and len(rows) == 8
    assert [(r["sweep"], r["algo"], r["grid"], r["mesh"]) for r in two] == [
        ("strong", "standard_2d", "24x20", "1x2"),
        ("strong", "wide_halo", "24x20", "1x2"),
        ("weak", "standard_2d", "8x16", "1x2"),
        ("weak", "wide_halo", "8x16", "1x2")]
    assert all(r["backend"] == "gloo" and r["cards"] == 0 and
               r["Mptsub_s"] > 0 and r["efficiency"] > 0 for r in two)


def test_perf_inputs_are_the_jax_packages():
    """The sweep's EVP problem: the JAX package draws its ice from
    jax.random, the port from numpy (0.5 to 1 on every cell, twice as
    thick); the grid and the EVP parameters are the JAX package's."""
    from cice_tpu.cli import perf as jperf
    from cice_tpu_torch.cli import perf as tperf
    args, kw = tperf._setup(10, 12, 4, "cpu")
    grid, p, prep, strength, z3, z = jperf._setup(10, 12, 4)
    np.testing.assert_allclose(np.array(list(args[1]), np.float64),
                               np.array(list(p), np.float64), rtol=1e-15)
    np.testing.assert_allclose(args[0].tarea.numpy(),
                               np.asarray(grid.tarea), rtol=1e-6)
    for t, j in ((args[3], strength), (args[2].umassdti, prep.umassdti)):
        assert tuple(t.shape) == tuple(j.shape) and t.dtype == torch.float32
        assert 0.4 < float(t.max()) / float(np.asarray(j).max()) < 2.5
    assert sorted(kw) == ["uocn", "vocn"]


def test_qc_matches_the_jax_package(tmp_path, capsys):
    from cice_tpu.cli import qc as jqc
    from cice_tpu_torch.cli import qc as tqc
    rng = np.random.default_rng(11)
    base = 2.0 * rng.random((40, 8, 9))
    for noise in (0.0, 1e-3, 0.5):
        hb = base + noise * rng.standard_normal(base.shape)
        assert dataclasses.asdict(tqc.qc_compare(base, hb)) == \
            dataclasses.asdict(jqc.qc_compare(base, hb))
    # history series from the port's own files, read by both packages
    from cice_tpu_torch.model.driver import Model
    dirs = {}
    for fmt in ("npz", "cdf1"):
        d = str(tmp_path / fmt)
        cfg = tcli.build_config(_args("gbox12", [
            f"setup.history_dir={d}", f"setup.history_format={fmt}",
            'setup.histfreq=["1", "x", "x", "x", "x"]',
            "dynamics.ndte=10"]))
        Model(cfg, device="cpu", enable_history=True).run(3)
        dirs[fmt] = d
        t = tqc.load_history_series(d, "hi")
        np.testing.assert_array_equal(t, jqc.load_history_series(d, "hi"))
        assert t.shape == (3, 12, 12) and t.max() > 0
    np.testing.assert_allclose(tqc.load_history_series(dirs["npz"]),
                               tqc.load_history_series(dirs["cdf1"]),
                               rtol=1e-6)
    assert tcli.main(["qc", dirs["npz"], dirs["cdf1"]]) == 0
    assert "QC PASS" in capsys.readouterr().out


def test_plots(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    from cice_tpu_torch.model.driver import Model
    d = str(tmp_path / "h")
    cfg = tcli.build_config(_args("gbox12", [
        f"setup.history_dir={d}", "setup.history_format=npz",
        'setup.histfreq=["1", "x", "x", "x", "x"]', "dynamics.ndte=10"]))
    m = Model(cfg, device="cpu", enable_history=True)
    m.run(1)
    path = os.path.join(d, os.listdir(d)[0])
    assert tcli.main(["plot2d", path, "-f", "hi", "--out",
                      str(tmp_path / "hi.png")]) == 0
    log = tmp_path / "diag.json"
    log.write_text(json.dumps([{"area_nh": 1.0, "area_sh": 2.0},
                               {"area_nh": 1.5, "area_sh": 2.5}]))
    assert tcli.main(["timeseries", str(log), "-k", "area_nh"]) == 0
    assert os.path.getsize(tmp_path / "hi.png") > 0
    assert os.path.getsize(tmp_path / "diag.png") > 0


def test_plots_without_matplotlib_exit(monkeypatch, tmp_path):
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    from cice_tpu_torch.cli import plots
    with pytest.raises(SystemExit, match="matplotlib"):
        plots.plot2d([str(tmp_path / "x.npz")])


def test_python_dash_m_the_package():
    import subprocess
    import sys
    r = subprocess.run([sys.executable, "-m", "cice_tpu_torch", "--help"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "{run,case,test,suite,perf,qc,plot2d,timeseries}" in r.stdout


def test_run_profile_writes_a_trace(tmp_path, capsys):
    rc = tcli.main(["run", "--steps", "1", "--profile", str(tmp_path / "p"),
                    "--device", "cpu", "--set", "grid.nx_global=8",
                    "--set", "grid.ny_global=6", "--set", "dynamics.ndte=2",
                    "--set", "thermo.nit=2"])
    out = capsys.readouterr().out
    assert rc == 0 and '"istep": 1' in out
    assert '"syncs": {' in out
    trace = tmp_path / "p" / "run.pt.trace.json"
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::add" for e in events)
    # the program's own ranges: phases, blocking reads, Timers
    ranges = {e["name"] for e in events
              if e.get("cat") == "user_annotation"}
    assert {"ice:therm1", "ice:dyn", "ice:transport", "ice:ridge",
            "sync:picard", "sync:rebin", "sync:ridge", "Forcing",
            "History"} <= ranges
    # the benchmark's names for its window and its phases stay its own
    assert not any(r == "step" or r.startswith("phase:") for r in ranges)


@pytest.mark.parametrize("opts", ["evpwide", "iopio", "iopio2"])
def test_a8_option_sets_run_through_the_cli(opts, capsys):
    """evpwide runs the one-program EVP on one process; iopio and iopio2
    write pio restarts (a directory of shards) that the restart test
    resumes from bit for bit (the iopio case is the io suite's iopio
    row)."""
    assert ("restart", "iopio") in tcli.SUITES["io"]
    want = {"evpwide": ("dynamics", "evp_algorithm", "wide_halo")}.get(
        opts, ("setup", "restart_format", "pio"))
    cfg = tcli.build_config(_args(opts))
    assert getattr(getattr(cfg, want[0]), want[1]) == want[2]
    rc = tcli.main(["test", "--type", "restart", "--opts", opts,
                    "--device", "cpu", "--set", "grid.nx_global=12",
                    "--set", "grid.ny_global=10"])
    out = capsys.readouterr().out
    assert rc == 0 and "PASS test_restart" in out, out
