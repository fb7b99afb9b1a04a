"""PyTorch port vs JAX package: the column options as a whole. Two coupled
steps (Model.step) of the gx1pop_step configuration on the 48x40
displaced-pole POP grid (tests/test_torch_step.py's), f64, with history,
in two option sets:

- `mushy,dedd`: mushy thermodynamics (ktherm=2, tfrz_option='mushy') and
  delta-Eddington shortwave, with the default level ponds: CICE's
  standard column physics;
- the composite of `snwgrain`, `fsd12`, `fdrag` and `pondtopo`: snow
  physics with wind redistribution, 12 floe-size bins with wave spectra,
  form drag and topographic ponds.

Each JAX configuration compiles model_step once: the perturbed run below
reuses the compiled step (cice_tpu's process-wide jit of model_step keys
on the configuration).

Tolerances: test_torch_step.py's f64 rtol 1e-8 of each field's largest
value with its absolute FLOORS, or 50 times the JAX package's own
envelope, whichever is larger: how far the JAX result moves when vicen
moves by 1e-15 (tests/test_torch_evp_c.py's bar). In midwinter the ponds
hold rounding residue of the converged surface balance (apnd ~ 4e-9 from
~1e-17 m of melt), and the topographic ponds grow a Stefan lid (ipnd ~ 3
cm) under that residue pond: the transport carries ipnd with the weight
apnd, so ipnd, the lid growth and the pond fresh-water flux are
residue-driven, and the JAX package moves them by their whole size under
the 1e-15 perturbation (ipnd: 0.0296 of 0.0297). The envelope holds them.

Also here: the history groups of the options (registration in the JAX
package's order; the accumulated stream and, for mushy,dedd, the cdf1
file), restarts that carry the new tracers across the packages in npz,
cdf1 and hdf5, the CLI smoke test of mushy,dedd, and check_ported's
acceptance of the biogeochemical options (the z tracers need the brine
tracer; 'clim' concentrations are refused).

The box2001 forcing of gx1pop_step has no shortwave: these steps hold
delta-Eddington's albedos, and tests/test_torch_dedd.py holds its absorbed
fluxes in the sun. (A summer start under the seasonal atmosphere gives
~40 W/m2 and no melt yet in two steps: the ponds stay residue there too.)

The slow tier adds pondsealvl, saltflux, alt05 and alt06 in f64, and the
f32 runs of both sets (rtol 2e-3, test_torch_step.py's f32 bar).
"""

import argparse
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402

from cice_tpu.calendar import Calendar as JCalendar  # noqa: E402
from cice_tpu.io import history as jhist  # noqa: E402
from cice_tpu.io import restart as jrestart  # noqa: E402
from cice_tpu.model.driver import Model as JModel  # noqa: E402
from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.cli import main as tcli  # noqa: E402
from cice_tpu_torch.io import history_fields as tfields  # noqa: E402
from cice_tpu_torch.io import restart as trestart  # noqa: E402
from cice_tpu_torch.model import driver as tdriver  # noqa: E402
from cice_tpu_torch.model.state import state_leaves  # noqa: E402
from cice_tpu_torch.model.step import check_ported  # noqa: E402
import test_torch_history as th  # noqa: E402
import test_torch_step as ts  # noqa: E402
from test_torch_restart import _jax_leaves, _jax_state  # noqa: E402

STEPS = 2
ENVELOPE = 50.0
MUSHY_DEDD = {"thermo.ktherm": 2, "thermo.tfrz_option": "mushy",
              "shortwave.shortwave": "dEdd"}
COMPOSITE = {"tracers.tr_snow": True, "snow.snwgrain": True,
             "snow.snwredist": "bulk", "tracers.tr_fsd": True,
             "domain.nfsd": 12, "forcing.wave_spec_type": "profile",
             "forcing.formdrag": True, "tracers.tr_pond_lvl": False,
             "tracers.tr_pond_topo": True}
SETS = {"mushy_dedd": MUSHY_DEDD, "composite": COMPOSITE}
# the slow tier: the CLI option sets of the JAX package (cice_tpu/cli/
# main.py), on top of gx1pop_step
SLOW_SETS = {
    "pondsealvl": {"tracers.tr_pond_lvl": False,
                   "tracers.tr_pond_topo": False,
                   "tracers.tr_pond_sealvl": True, "ponds.apnd_sl": 0.27,
                   "ponds.rfracmin": 1.0, "ponds.rfracmax": 1.0,
                   "ponds.tscale_pnd_drain": 0.5},
    "saltflux": {"thermo.ktherm": 2, "thermo.tfrz_option": "mushy",
                 "thermo.saltflux_option": "prognostic"},
    "alt05": {"tracers.tr_iage": False, "tracers.tr_FY": False,
              "tracers.tr_lvl": False, "tracers.tr_pond_lvl": False,
              "tracers.tr_pond_topo": False, "shortwave.shortwave": "dEdd"},
    "alt06": {"domain.ncat": 7, "grid.kcatbound": 3, "domain.nslyr": 3,
              "thermo.tfrz_option": "mushy"},
}
HIST = {"setup.histfreq": ("d", "1", "x", "x", "x"),
        "setup.histfreq_n": (1, STEPS, 1, 1, 1),
        "setup.hist_avg": (True, False, True, True, True),
        "setup.hist_cmip": True}


def _cfgs(dtype, root, over):
    return ts._cfgs(dtype, **{**over, **HIST,
                              "setup.history_dir": os.path.join(
                                  str(root), "hist")})


def _jax_steps(jcfg, pert=0.0):
    """The JAX Model with history after STEPS steps from the initial state
    with vicen x (1 + pert), and [(state, flux)] per step."""
    jm = JModel(jcfg, enable_history=True)
    jm.state = jm.state.replace(vicen=jm.state.vicen * (1.0 + pert))
    out = []
    for _ in range(STEPS):
        jm.step()
        out.append((ts._tree(jm.state), ts._tree(jm.flux)))
    return jm, out


def _run_pair(name, dtype, root, over):
    tcfg, jcfg = _cfgs(dtype, root, over)
    # f32 runs the JAX package without x64, its production setting: with
    # x64 on, its float64 constants (the FSD radii, the snow tables, the
    # sea-level pond fraction) promote a float32 state, and its Picard
    # while_loop then refuses the carry
    with jax.enable_x64(dtype == "float64"):
        jm, ref = _jax_steps(jcfg)
        jenv, env = _jax_steps(jcfg, 1e-15 if dtype == "float64" else 2e-7)
    tm = tdriver.Model(tcfg, grid=th._port_grid(jm.grid), device="cpu",
                       enable_history=True)
    got = []
    for _ in range(STEPS):
        tm.step()
        got.append((ts._tree(convert.state_to_numpy(tm.state)),
                    ts._tree(convert.fluxout_to_numpy(tm.flux))))
    return dict(name=name, dtype=dtype, jm=jm, jenv=jenv, tm=tm, ref=ref,
                env=env, got=got, tcfg=tcfg, jcfg=jcfg)


def _atol(leaf, b, e, dtype):
    f32 = dtype == "float32"
    atol = max(ts.RTOL[dtype] * float(np.abs(b).max()),
               ts._floor(leaf, b, f32))
    return max(atol, ENVELOPE * float(np.abs(e - b).max()))


def _check_steps(run):
    dtype = run["dtype"]
    f32 = dtype == "float32"
    for step in range(STEPS):
        for part in range(2):
            g, r = run["got"][step][part], run["ref"][step][part]
            e = run["env"][step][part]
            what = f"{run['name']} {dtype} step {step + 1} " \
                   f"{('state', 'flux')[part]}"
            extra = {"transport_checks.neg_mass_depth"}
            assert set(r) <= set(g) and set(g) - set(r) <= extra, \
                (what, set(g) ^ set(r))
            for k in r:
                leaf = k.split(".")[-1]
                a, b = np.asarray(g[k]), np.asarray(r[k])
                assert a.shape == b.shape, (what, k)
                if b.dtype == np.bool_:
                    np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")
                elif leaf in ts.CHECK_BOUNDS:
                    bound = ts.CHECK_BOUNDS[leaf][f32]
                    assert float(a) < bound and float(b) < bound, (what, k)
                else:
                    np.testing.assert_allclose(
                        a, b, rtol=ts.RTOL[dtype],
                        atol=_atol(leaf, b, np.asarray(e[k]), dtype),
                        err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {name: _run_pair(name, "float64", tmp_path_factory.mktemp(name),
                            over)
            for name, over in SETS.items()}


@pytest.mark.parametrize("name", list(SETS))
def test_two_steps_match_jax_f64(runs, name):
    run = runs[name]
    _check_steps(run)
    st, fl = run["ref"][-1]
    assert float(np.abs(st["uvel"]).max()) > 1e-3            # ice moves
    assert float(fl["congel"].max()) > 0.0                    # and grows
    assert float(fl["alvdr"].max()) > 0.5          # the shortwave's albedos
    tr = run["got"][-1][0]
    if name == "mushy_dedd":
        assert float(fl["fsalt"].max()) > 0.0    # gravity drainage
        s = tr["trcrn.sice"]
        assert s.max() > s.min() + 1.0           # prognostic salinity
    else:
        assert float(np.abs(fl["ncat_fluxes.dafsd_wave"]).max()) > 0.0
        assert float(tr["trcrn.rsnw"].max()) > 100.0


@pytest.mark.parametrize("name", list(SETS))
def test_history_stream_matches_jax(runs, name):
    """The daily stream after the two steps, every field (the option
    groups among them) against the JAX stream, within the envelope of the
    perturbed JAX run's stream."""
    run = runs[name]
    tstream = run["tm"].history.streams[0]
    jstream = run["jm"].history.streams[0]
    assert [f.name for f in tstream.fields] == \
        [f.name for f in jstream.fields]
    got = th._stream_np(run["tm"].history, tstream)
    ref = th._stream_np(run["jm"].history, jstream)
    env = th._stream_np(run["jenv"].history, run["jenv"].history.streams[0])
    groups = {"mushy_dedd": ("Tinz", "Sinz", "sitempbot", "sitempsnic"),
              "composite": ("rsnw", "smassice", "fsdrad", "afsd",
                            "dafsd_wave", "wave_sig_ht", "Cdn_atm",
                            "Cdn_ocn_floe", "lfloe", "sidragtop")}[name]
    assert set(groups) <= set(ref)
    for k in ref:
        scale = float(np.abs(ref[k]).max())
        atol = max(ts.RTOL["float64"] * scale, th.FLOORS.get(k, 0.0),
                   ENVELOPE * float(np.abs(env[k] - ref[k]).max()))
        np.testing.assert_allclose(got[k], ref[k], rtol=ts.RTOL["float64"],
                                   atol=atol, err_msg=f"{name}: {k}")
    zero = [k for k in groups if float(np.abs(ref[k]).max()) == 0.0]
    assert not zero, zero


def test_mushy_dedd_history_file_matches_jax(runs, tmp_path):
    run = runs["mushy_dedd"]
    hist_t, hist_j = run["tm"].history, run["jm"].history
    tp = th._write(hist_t, hist_t.streams[0], run["tm"].calendar,
                   tmp_path / "port", "cdf1")
    jp = th._write(hist_j, hist_j.streams[0], run["jm"].calendar,
                   tmp_path / "jax", "cdf1")
    th._compare_nc(tp, jp)


@pytest.mark.parametrize("over", [
    MUSHY_DEDD, COMPOSITE, SLOW_SETS["pondsealvl"], SLOW_SETS["alt06"],
    {**COMPOSITE, "forcing.wave_spec_type": "file",
     "snow.snw_aging_table": "test"}],
    ids=["mushy_dedd", "composite", "pondsealvl", "alt06", "wave_file"])
def test_history_groups_register_in_jax_order(over):
    tcfg, jcfg = _cfgs("float64", "/nonexistent", over)
    got = th._registry(tfields.build_fields(tcfg), tfields.nrows)
    ref = th._registry(jhist.build_fields(jcfg), jhist._nrows)
    assert got == ref


@pytest.mark.parametrize("fmt", ["npz", "cdf1", "hdf5"])
@pytest.mark.parametrize("name", list(SETS))
def test_restarts_with_the_new_tracers_cross_between_packages(
        runs, name, fmt, tmp_path):
    """The port's state (sice under mushy; smice, smliq, rhos_cmp, rsnw,
    fsd) written by the port and read by the JAX package, and written by
    the JAX package and read by the port, bit for bit."""
    if fmt == "hdf5":
        pytest.importorskip("h5py")
    m = runs[name]["tm"]
    names = set(m.state.trcrn)
    assert {"sice"} <= names and (name == "mushy_dedd" or {
        "smice", "smliq", "rhos_cmp", "rsnw", "fsd"} <= names)
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


def test_cli_smoke_test_of_mushy_dedd(capsys):
    rc = tcli.main(["test", "--type", "smoke", "--opts", "mushy,dedd",
                    "--device", "cpu", "--set", "grid.nx_global=12",
                    "--set", "grid.ny_global=10"])
    assert rc == 0, capsys.readouterr().out
    assert "PASS test_smoke" in capsys.readouterr().out


@pytest.mark.parametrize("opts", [
    "mushy", "dedd", "snwgrain", "snw30percent", "snwitdrdg", "fsd1",
    "fsd12", "fsd12ww3", "pondtopo", "pondsealvl", "saltflux", "fdrag",
    "alt05", "alt06"])
def test_column_option_sets_run_through_the_cli(opts, capsys):
    """Each column option set of the JAX package's table steps on the CPU
    through `cli run` (box2001 at 12x10)."""
    rc = tcli.main(["run", "--device", "cpu", "--opts", f"box2001,{opts}",
                    "--steps", "2", "--set", "grid.nx_global=12",
                    "--set", "grid.ny_global=10",
                    "--set", "dynamics.ndte=10"])
    assert rc == 0, capsys.readouterr().out


@pytest.mark.parametrize("over", [
    {"tracers.tr_aero": True, "domain.n_aero": 1},
    {"tracers.tr_iso": True, "domain.n_iso": 1},
    {"tracers.tr_brine": True}, {"zbgc.skl_bgc": True},
    {"zbgc.z_tracers": True}, {"forcing.highfreq": True},
    {"shortwave.shortwave": "dEdd", "zbgc.dEdd_algae": True}],
    ids=["aero", "iso", "brine", "skl_bgc", "z_tracers", "highfreq",
         "dEdd_algae"])
def test_check_ported_refuses_the_biogeochemistry(over):
    """(Kept name: check_ported refused these options until the
    biogeochemistry was ported.) It accepts each of them now; z tracers
    without the brine tracer are refused with a ValueError naming both
    flags (the JAX package fails there: its z tracers' transport parent
    fbri is not registered), and accepted with it."""
    cfg = tconfig.Config().with_overrides(**over)
    if "zbgc.z_tracers" in over:
        with pytest.raises(ValueError, match="z_tracers.*tr_brine"):
            check_ported(cfg)
        cfg = cfg.with_overrides(**{"tracers.tr_brine": True})
    check_ported(cfg)


@pytest.mark.parametrize("opts", ["bgcsklclim", "bgczclim"])
def test_bgc_climatology_option_sets_are_refused(opts):
    """'clim' mixed-layer nitrate and silicate: no BGC climatology reader
    exists (the JAX package fails converting the string); Model refuses
    the configuration before it builds any state."""
    cfg = tcli.build_config(argparse.Namespace(opts=opts, set=None))
    with pytest.raises(ValueError, match="nit_data.*climatology"):
        tdriver.Model(cfg, device="cpu")


@pytest.mark.parametrize("over", [
    MUSHY_DEDD, COMPOSITE, {"shortwave.shortwave": "dEdd_snicar_ad"},
    {"tracers.tr_snow": True, "snow.snw_aging_table": "file",
     "snow.snw_filename": "table.npz"},
    {"tracers.tr_fsd": True, "forcing.wave_spec_type": "random"},
    {"tracers.tr_pond_lvl": False, "tracers.tr_pond_sealvl": True}],
    ids=["mushy_dedd", "composite", "snicar_ad", "snow_file", "fsd_random",
         "sealvl"])
def test_check_ported_accepts_the_column_options(over):
    check_ported(tconfig.Config().with_overrides(**over))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SLOW_SETS))
def test_other_option_sets_two_steps_match_jax_f64(name, tmp_path):
    _check_steps(_run_pair(name, "float64", tmp_path, SLOW_SETS[name]))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SETS))
def test_two_steps_match_jax_f32(name, tmp_path):
    _check_steps(_run_pair(name, "float32", tmp_path, SETS[name]))
