"""PyTorch port vs JAX package: the slice as a whole. Two full coupled
steps (`Model.step`: step_therm1, step_therm2, EVP dynamics, exact remap,
ridging, ocean mixed layer, FluxOut) of the `gx1pop_step` configuration on a
small displaced-pole POP grid (48x40, ndte=40) from the model's initial
state, against `cice_tpu.model.step.model_step` jitted on the same forcing;
`step_therm1` alone, every key of its `agg`; and Model.step's diagnostics.

The JAX side runs evp_algorithm='standard_2d' and remap_kernel='xla': its
fused kernels are f32-only and need a TPU or the interpreter. The port runs
'fused_pallas' for both; on CPU tensors every wrapper reaches its plain
version.

Tolerances. f64: rtol 1e-8 of each field's largest value (the same
expressions in the same order; math-library and reduction-order differences
of ~1e-16 grow through 2 x 40 EVP subcycles and the Picard solve by a few
orders at most). f32: the JAX package's engine-vs-engine scale, 2e-3 of
each field's largest value. Fields that hold rounding residue get an
absolute floor, each with its reason in FLOORS.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402

from cice_tpu import constants as jcst  # noqa: E402
from cice_tpu.config import Config  # noqa: E402
from cice_tpu.model import diagnostics as jdiag  # noqa: E402
from cice_tpu.model.driver import Model as JModel  # noqa: E402
from cice_tpu.model.forcing import get_forcing as jget_forcing  # noqa: E402
from cice_tpu.model.step import model_step as jmodel_step  # noqa: E402
from cice_tpu.model.step import step_therm1 as jstep_therm1  # noqa: E402
from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.model import diagnostics as tdiag  # noqa: E402
from cice_tpu_torch.model import driver as tdriver  # noqa: E402
from cice_tpu_torch.model.step import step_therm1 as tstep_therm1  # noqa: E402

NX, NY, NDTE, STEPS = 48, 40, 40, 2
RTOL = {"float64": 1e-8, "float32": 2e-3}

# Absolute floors (f64, f32) for fields that hold rounding residue.
#  * In midwinter the top-melt energy max(fsurf - fcondtop, 0) * dt is the
#    residue of the converged surface balance: ~1e-17 m of snow melt in f64
#    (~1e-9 in f32). The ponds collect it (dpnd_initial, fpond), and
#    apnd = sqrt(volume / aspect) turns 1e-17 into ~4e-9 (f32: ~1e-4).
#  * daidtt: thermodynamics changes no area here; the field is the rounding
#    of (aice_after - aice_before) / dt.
#  * dpnd_ridge: pond water on ridged area, a product with the apnd above.
#  * fresh, fsalt, fhocn, dvidtt, dvsdtt and the like are differences of
#    thicknesses (or ages) per dt: in f32 they carry a few ulp of the
#    differenced quantity over dt (2.4e-7 * 3.5 m / 3600 s = 2e-10 m/s for
#    dvidtt, times rhoi for fresh, times rhoi * Lfresh for fhocn).
_MELT = (1e-12, 1e-6)
FLOORS = {
    "melts": _MELT, "meltt": _MELT, "dpnd_initial": _MELT,
    "dpnd_initialn": _MELT, "fpond": (1e-12, 1e-6),
    "apond": (1e-7, 1e-3), "apeff": (1e-7, 1e-3), "apeffn": (1e-7, 1e-3),
    "albpnd": (1e-7, 1e-3),
    "apnd": (1e-7, 1e-3), "hpnd": (1e-7, 1e-3),
    "daidtt": (1e-15, 1e-9), "dpnd_ridge": (1e-15, 1e-9),
    "dpnd_melt": (1e-15, 1e-9),
    "fresh": (0.0, 1e-6), "fsalt": (0.0, 1e-8), "fhocn": (0.0, 0.3),
    "dvidtt": (0.0, 1e-9), "dvsdtt": (0.0, 1e-9), "dvidtd": (0.0, 1e-9),
    "dvsdtd": (0.0, 1e-9), "daidtd": (0.0, 1e-9), "dagedtt": (0.0, 1e-3),
    "dagedtd": (0.0, 1e-3), "evaps": (0.0, 1e-9),
}
# roundoff-sized check values: both sides must stay under the bound
CHECK_BOUNDS = {"cons_err_area": (1e-12, 1e-5),
                "cons_err_tracer": (1e-10, 1e-4)}


def _cfgs(dtype, **over):
    base = {"dynamics.ndte": NDTE, "setup.conserv_check": True,
            "dtype": dtype}
    base.update(over)
    tcfg = tconfig.gx1pop_step(NX, NY).with_overrides(**base)
    g = tcfg.grid
    jcfg = Config().with_overrides(**{
        "grid.nx_global": NX, "grid.ny_global": NY,
        "grid.grid_format": "pop_bin", "grid.grid_type": "displaced_pole",
        "grid.grid_file": g.grid_file, "grid.kmt_file": g.kmt_file,
        "grid.ew_boundary_type": "cyclic", "dynamics.coriolis": "latitude",
        "dynamics.remap_kernel": "xla", **base})
    return tcfg, jcfg


_tree = convert.tree_to_numpy    # {dotted key: array} of any nest


def _compare(got, ref, what, dtype):
    g, r = _tree(got), _tree(ref)
    extra = {"transport_checks.neg_mass_depth"}     # the port's addition
    assert set(r) <= set(g) and set(g) - set(r) <= extra, \
        (what, set(g) ^ set(r))
    f32 = dtype == "float32"
    for k in r:
        leaf = k.split(".")[-1]
        a, b = np.asarray(g[k]), np.asarray(r[k])
        assert a.shape == b.shape, (what, k)
        if b.dtype == np.bool_:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")
        elif leaf in CHECK_BOUNDS:
            bound = CHECK_BOUNDS[leaf][f32]
            assert float(a) < bound and float(b) < bound, (what, k, a, b)
        else:
            scale = float(np.abs(b).max())
            atol = max(RTOL[dtype] * scale, FLOORS.get(leaf, (0, 0))[f32])
            np.testing.assert_allclose(a, b, rtol=RTOL[dtype], atol=atol,
                                       err_msg=f"{what}: {k}")


def _jax_run(dtype, steps=STEPS, with_agg=False, **over):
    """The JAX reference: (initial state, [(state, flux)] per step, agg of
    the first step's step_therm1)."""
    _, jcfg = _cfgs(dtype, **over)
    m = JModel(jcfg)
    dt = jcfg.setup.dt
    fn = jax.jit(lambda s, fc: jmodel_step(m.static, m.grid, s, fc, dt))
    st, fc, out, agg = m.state, m.forcing, [], None
    for step in range(steps):
        t = step * dt
        fc = jget_forcing(jcfg, m.grid, t, 1.0 + t / jcst.secday, st.aice, fc)
        if with_agg and step == 0:
            agg = _tree(jax.jit(lambda s, f: jstep_therm1(
                m.static, m.grid, s, f, dt))(st, fc))
        pre = st
        st, fl = fn(st, fc)
        out.append((_tree(st), _tree(fl)))
    diags = None
    if with_agg:
        diags = dict(
            runtime=_tree(jdiag.runtime_diags(m.grid, st)),
            energy=np.asarray(jdiag.total_energy(m.grid, st)),
            water=np.asarray(jdiag.total_water_mass(m.grid, st)),
            pond=np.asarray(jdiag.total_pond_mass(m.grid, st, True)),
            check=_tree(jdiag.check_state(st)),
            budgets=_tree(jdiag.hemispheric_budgets(
                m.grid, pre, st, fl, fc, dt, pond_lvl=True)))
    return _tree(m.state), out, agg, diags


@pytest.fixture(scope="module")
def jax_f64():
    return _jax_run("float64", with_agg=True)


def test_step_therm1_matches_jax_f64(jax_f64):
    """Every key of step_therm1's agg, the new state and hicen_old."""
    _, _, agg, _ = jax_f64
    tcfg, _ = _cfgs("float64")
    m = tdriver.Model(tcfg, device="cpu")
    from cice_tpu_torch.model.forcing import get_forcing
    fc = get_forcing(tcfg, m.grid, 0.0, 1.0, m.state.aice, m.forcing)
    got = tstep_therm1(m.static, m.grid, m.state, fc, tcfg.setup.dt)
    _compare(got, agg, "step_therm1", "float64")
    assert float(np.abs(agg["1.strairx"]).max()) > 1e-3
    assert float(agg["1.congel"].max()) > 0.0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_two_coupled_steps_match_jax(jax_f64, dtype):
    init, ref, _, _ = jax_f64 if dtype == "float64" else _jax_run(dtype)
    tcfg, _ = _cfgs(dtype)
    m = tdriver.Model(tcfg, device="cpu")
    _compare(convert.state_to_numpy(m.state), init, "initial", dtype)
    for step, (jst, jfl) in enumerate(ref):
        m.step()
        _compare(convert.state_to_numpy(m.state), jst,
                 f"{dtype} step {step + 1} state", dtype)
        _compare(convert.fluxout_to_numpy(m.flux), jfl,
                 f"{dtype} step {step + 1} flux", dtype)
    last = ref[-1][1]
    assert float(np.abs(ref[-1][0]["uvel"]).max()) > 1e-3   # ice moves
    assert float(last["dardg1dt"].max()) > 0.0               # and ridges
    assert float(last["congel"].max()) > 0.0                 # and grows
    assert not bool(m.tchecks["oob"]) and not bool(m.tchecks["neg_mass"])


@pytest.mark.parametrize("over", [
    {"dynamics.kridge": 1, "forcing.calc_strair": False},
    {"dynamics.kridge": -1, "forcing.calc_strair": True}],
    ids=["kridge", "calc_strair"])
def test_ridging_and_boundary_layer_stress_each_run(over):
    """kridge=1 and calc_strair=True, each alone, run and match JAX."""
    _, ref, _, _ = _jax_run("float64", steps=1, **over)
    tcfg, _ = _cfgs("float64", **over)
    m = tdriver.Model(tcfg, device="cpu")
    m.step()
    _compare(convert.state_to_numpy(m.state), ref[0][0], "state", "float64")
    _compare(convert.fluxout_to_numpy(m.flux), ref[0][1], "flux", "float64")
    ridged = float(ref[0][1]["dardg1dt"].max()) > 0.0
    assert ridged == (over["dynamics.kridge"] == 1)


def test_diagnostics_match_jax_f64(jax_f64):
    _, _, _, jd = jax_f64
    tcfg, _ = _cfgs("float64")
    m = tdriver.Model(tcfg, device="cpu")
    m.step()
    pre = m.state
    m.step()
    g, st = m.grid, m.state
    got = dict(
        runtime=tdiag.runtime_diags(g, st),
        energy=tdiag.total_energy(g, st),
        water=tdiag.total_water_mass(g, st),
        pond=tdiag.total_pond_mass(g, st, True),
        check=tdiag.check_state(st),
        budgets=tdiag.hemispheric_budgets(g, pre, st, m.flux, m.forcing,
                                          tcfg.setup.dt, pond_lvl=True))
    got, ref = _tree(got), _tree(jd)
    assert got.keys() == ref.keys()
    # residuals and the pond mass are differences of ~1e13-1e17 kg (J)
    # totals or products with the rounding-sized pond fraction: compared
    # on the scale of the totals they close
    scale_of = {"budgets.water_residual": "budgets.dM",
                "budgets.heat_residual": "budgets.dE",
                "budgets.rain_in": "budgets.snow_in", "pond": "water"}
    for k, r in ref.items():
        if r.dtype == np.bool_:
            assert bool(got[k]) == bool(r), k
            continue
        scale = abs(float(ref[scale_of.get(k, k)]))
        assert abs(float(got[k]) - float(r)) <= 1e-8 * scale + 1e-300, \
            (k, got[k], r)
    assert abs(float(ref["budgets.water_residual"])) < \
        1e-2 * abs(float(ref["budgets.dM"]))


def test_run_logs_diagnostics_and_counts_steps():
    tcfg, _ = _cfgs("float32", **{"setup.diagfreq": 2})
    m = tdriver.Model(tcfg, device="cpu")
    m.run(2)
    assert m.istep == 2 and m.elapsed_seconds == 2 * tcfg.setup.dt
    assert m.yday == pytest.approx(1.0 + 2 * tcfg.setup.dt / 86400.0)
    assert len(m.diag_log) == 1
    rec = m.diag_log[0]
    for k in ("area_nh", "volume_sh", "umax", "total_energy", "total_water",
              "bud_water_residual", "transport_cons_err"):
        assert np.isfinite(rec[k]), k
    assert abs(rec["bud_water_residual"]) <= 1e-2 * max(
        abs(rec["bud_dM"]), abs(rec["bud_water_in"]))


def test_freshwater_budget_violation_aborts(monkeypatch):
    """Model.step's 1 % rule: a lost budget term stops the run."""
    tcfg, _ = _cfgs("float32", **{"setup.diagfreq": 1})
    m = tdriver.Model(tcfg, device="cpu")
    real = tdiag.hemispheric_budgets

    def leaky(*a, **k):
        bud = real(*a, **k)
        bud["water_residual"] = bud["dM"] * 0.5 + 1e6
        return bud
    monkeypatch.setattr(tdiag, "hemispheric_budgets", leaky)
    with pytest.raises(RuntimeError, match="freshwater budget"):
        m.step()


def test_transport_check_failure_aborts(monkeypatch):
    tcfg, _ = _cfgs("float32", **{"setup.diagfreq": 1})
    m = tdriver.Model(tcfg, device="cpu")
    real = tdriver.model_step

    def flagged(*a, **k):
        st, fl = real(*a, **k)
        tc = dict(fl.transport_checks, oob=torch.tensor(True))
        return st, fl.replace(transport_checks=tc)
    monkeypatch.setattr(tdriver, "model_step", flagged)
    with pytest.raises(RuntimeError, match="departure points"):
        m.step()


UNPORTED = {
    "dEdd": {"shortwave.shortwave": "dEdd"},
    "mushy": {"thermo.ktherm": 2},
    "fsd": {"tracers.tr_fsd": True},
    "tr_snow": {"tracers.tr_snow": True},
    "formdrag": {"forcing.formdrag": True},
}


@pytest.mark.parametrize("branch", list(UNPORTED))
def test_unported_branches_raise_naming_roadmap(branch):
    """Branches of model_step whose modules wait raise, never skip."""
    tcfg, _ = _cfgs("float32", **UNPORTED[branch])
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        tdriver.Model(tcfg, device="cpu").step()


def test_fluxout_numpy_round_trip():
    tcfg, _ = _cfgs("float32")
    m = tdriver.Model(tcfg, device="cpu")
    m.step()
    d = convert.fluxout_to_numpy(m.flux)
    back = convert.fluxout_to_numpy(convert.fluxout_from_numpy(d, "cpu"))
    assert _tree(back).keys() == _tree(d).keys()
    for k, v in _tree(d).items():
        np.testing.assert_array_equal(_tree(back)[k], v, err_msg=k)
