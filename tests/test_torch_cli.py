"""The port's CLI (cice_tpu_torch.cli) against the JAX package's: the
option-set table, composition of --opts and --set, "{FIX}" resolution to
the port's own fixture root, compare_series on the committed r05 series,
the unknown-option message, and a smoke test and a restart test on the
CPU."""

import argparse
import json
import os

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
    """The multi-GPU EVP (A8) and the background writer (A7) raise naming
    their ROADMAP items; `modal` (aerosols with modal optics in dEdd),
    which raised until the biogeochemistry was ported, builds a Model."""
    from cice_tpu_torch.model.driver import Model
    for opts, item in (("evpwide", "ROADMAP A8"),
                       ("gridc,evpwide", "ROADMAP A8"),
                       ("ioasync", "ROADMAP A7")):
        cfg = tcli._default_test_cfg(_args(opts, type="smoke"),
                                     tcli.build_config(_args(opts)))
        with pytest.raises(NotImplementedError, match=item):
            Model(cfg, device="cpu")
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