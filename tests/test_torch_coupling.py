"""The coupler surface of the PyTorch port (cice_tpu_torch/model/coupling.py)
against the JAX package's (cice_tpu/model/coupling.py).

- The three surfaces of tests/test_coupling.py on the port's CoupledIce.
- `export_fields` against the JAX package's on the same state, flux and
  forcing (the port's, after one step with aerosols, isotopes and the FSD),
  to 1e-15 of each field's largest value in f64.
- Reference fault 1: the JAX package's coupled step calls the model's own
  forcing, so box2001 winds replace the imported ones; the port's coupled
  step equals the JAX package's `model_step` called on the JAX package's
  imported Forcing (stamped, as the port's step stamps it, with the ice's
  calendar day and solar zenith), to test_torch_step's f64 tolerance. One
  JAX compile: the reference call and the JAX package's own step share
  `cice_tpu.model.driver._model_step_jit`.
- Reference fault 2: an imported So_s leaves the JAX package's Tf at the
  default salinity's; the port's Tf follows it under thermo.tfrz_option.

Imports are made with numpy from a seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax.numpy as jnp  # noqa: E402

from cice_tpu.columns.ocean import freezing_temperature as jtf  # noqa: E402
from cice_tpu.config import box2001_config as jbox  # noqa: E402
from cice_tpu.model import driver as jdriver  # noqa: E402
from cice_tpu.model.coupling import CoupledIce as JCoupledIce  # noqa: E402
from cice_tpu.model.flux import Forcing as JForcing  # noqa: E402
from cice_tpu.model.flux import FluxOut as JFluxOut  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.config import box2001_config as tbox  # noqa: E402
from cice_tpu_torch.model.coupling import CoupledIce  # noqa: E402
import test_torch_step as ts  # noqa: E402
from test_torch_restart import _jax_state  # noqa: E402

N = 16


def _jax_flux(d):
    return JFluxOut(**{k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                           if isinstance(v, dict) else jnp.asarray(v))
                       for k, v in d.items()})


def _jax_forcing(fc):
    return JForcing(**{k: jnp.asarray(v)
                       for k, v in convert.forcing_to_numpy(fc).items()})


def _imports(shp, seed=0):
    """Coupler fields of a midwinter atmosphere and ocean."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: lo + (hi - lo) * rng.random(shp)
    tbot = u(245.0, 255.0)
    return {
        "Sa_u": u(-8.0, 8.0), "Sa_v": u(-8.0, 8.0), "Sa_z": np.full(shp, 10.0),
        "Sa_tbot": tbot, "Sa_ptem": tbot + 0.5, "Sa_shum": u(3e-4, 6e-4),
        "Sa_dens": u(1.25, 1.35), "Sa_pbot": u(9.9e4, 1.02e5),
        "Faxa_lwdn": u(170.0, 220.0), "Faxa_rain": np.zeros(shp),
        "Faxa_snow": u(0.0, 2e-5), "Faxa_swvdr": u(0.0, 5.0),
        "Faxa_swvdf": u(0.0, 5.0), "Faxa_swndr": u(0.0, 5.0),
        "Faxa_swndf": u(0.0, 5.0), "So_u": u(-0.1, 0.1),
        "So_v": u(-0.1, 0.1), "So_t": u(-1.9, -1.5),
        "So_dhdx": np.zeros(shp), "So_dhdy": np.zeros(shp),
        "So_hmix": u(15.0, 30.0), "Fioo_q": u(-60.0, 0.0)}


def _finite(out):
    return all(np.isfinite(convert.exports_to_numpy({k: v})[k]).all()
               for k, v in out.items())


# -- the three surfaces of tests/test_coupling.py ------------------------

def test_import_export_round():
    ice = CoupledIce(tbox(N, N), device="cpu")
    shp = ice.model.grid.shape
    ice.import_fields({
        "Sa_u": np.full(shp, 5.0), "Sa_v": np.zeros(shp),
        "Sa_tbot": torch.full(shp, 250.0), "Sa_ptem": np.full(shp, 250.0),
        "Faxa_lwdn": np.full(shp, 180.0),
        "So_t": np.full(shp, -1.5), "Fioo_q": np.full(shp, 50.0),
        "Not_a_field": "ignored"})
    fc = ice.model.forcing
    assert float(fc.Tair[0, 0]) == 250.0 and float(fc.wind[0, 0]) == 5.0
    assert float(ice.model.state.frzmlt[0, 0]) == 50.0
    assert fc.Tair.dtype == ice.model.cfg.np_dtype
    ice.step()
    # the imports survive the step: the coupler is the forcing
    assert float(ice.model.forcing.Tair[0, 0]) == 250.0
    out = ice.export_fields()
    for key in ("Si_ifrac", "Si_thick", "Faii_sen", "Fioi_melth",
                "Fioi_taux", "Si_avsdr"):
        assert key in out, key
        assert out[key].device == ice.model.grid.hm.device
    host = convert.exports_to_numpy(out)
    assert all(np.isfinite(v).all() for v in host.values())
    a = host["Si_ifrac"]
    assert a.max() <= 1.0 + 1e-6 and a.min() >= 0.0
    # scaled exports are per ice area: zero where there is no ice
    assert np.all(host["Faii_sen"][a < 1e-11] == 0.0)


def test_widened_field_surface():
    cfg = tbox(N, N).with_overrides(**{"tracers.tr_aero": True,
                                       "domain.n_aero": 3})
    ice = CoupledIce(cfg, device="cpu")
    shp = ice.model.grid.shape
    ice.import_fields({
        "Sa_pbot": np.full(shp, 1.0e5),
        "Faxa_bcph": np.full((3,) + shp, 1e-12),
        "Faxa_dstwet": np.full((4,) + shp, 2e-12),
        "Faxa_dstdry": np.full((4,) + shp, 1e-12)})
    fc = ice.model.forcing
    assert float(fc.pbot[0, 0]) == 1.0e5
    assert tuple(fc.faero_atm.shape) == (3,) + shp
    np.testing.assert_allclose(fc.faero_atm[2].numpy(), 12e-12, rtol=1e-5)
    np.testing.assert_allclose(fc.faero_atm[0].numpy(), 2e-12, rtol=1e-5)
    ice.step()
    out = ice.export_fields()
    for key in ("Si_tref", "Si_qref", "Si_u10", "Si_vice", "Si_vsno",
                "Si_ifrac_n", "Si_floediam", "Fioi_bcpho", "Fioi_bcphi",
                "Fioi_flxdst"):
        assert key in out, key
    assert _finite(out)
    assert tuple(out["Si_ifrac_n"].shape) == (cfg.domain.ncat,) + shp
    assert float(out["Si_floediam"].min()) > 0.0


def test_wiso_and_swpen_surface():
    cfg = tbox(N, N).with_overrides(**{"tracers.tr_iso": True,
                                       "domain.n_iso": 3})
    ice = CoupledIce(cfg, device="cpu")
    shp = ice.model.grid.shape
    ice.import_fields({
        "Sa_u": np.full(shp, 5.0), "Sa_v": np.zeros(shp),
        "Faxa_snow": np.full(shp, 1e-4),
        "Faxa_swvdr": np.full(shp, 100.0),
        "Faxa_swvdf": np.full(shp, 50.0),
        "Sa_shum_wiso": np.full((3,) + shp, 1e-4),
        "Faxa_snow_wiso": np.full((3,) + shp, 2e-5),
        "So_roce_wiso": np.ones((3,) + shp)})
    assert tuple(ice.model.forcing.fiso_atm.shape) == (3,) + shp
    np.testing.assert_allclose(ice.model.forcing.fiso_atm.numpy(), 2e-5)
    ice.step()
    out = ice.export_fields()
    for key in ("Fioi_swpen", "Fioi_swpen_vdr", "Fioi_swpen_vdf",
                "Fioi_swpen_idr", "Fioi_swpen_idf", "Fioi_swpen_ifrac_n",
                "Fioi_meltw_wiso", "Faii_evap_wiso", "Si_qref_wiso"):
        assert key in out, key
    assert _finite(out)
    host = convert.exports_to_numpy(out)
    np.testing.assert_allclose(host["Fioi_swpen_vdr"] +
                               host["Fioi_swpen_vdf"], host["Fioi_swpen"],
                               rtol=1e-5, atol=1e-7)
    assert float(np.abs(host["Fioi_swpen_idr"]).max()) == 0.0
    assert host["Fioi_swpen_ifrac_n"].shape == (cfg.domain.ncat,) + shp
    assert host["Fioi_meltw_wiso"].shape == (3,) + shp


# -- exports against the JAX package's on the same numbers ----------------

@pytest.mark.parametrize("scale", [True, False], ids=["scaled", "unscaled"])
def test_export_fields_match_jax(scale):
    over = {"dtype": "float64", "tracers.tr_aero": True, "domain.n_aero": 3,
            "tracers.tr_iso": True, "domain.n_iso": 3,
            "tracers.tr_fsd": True, "domain.nfsd": 4}
    ice = CoupledIce(tbox(N, N).with_overrides(**over), scale_fluxes=scale,
                     device="cpu")
    shp = ice.model.grid.shape
    ice.import_fields(dict(_imports(shp, 3),
                           Sa_shum_wiso=np.full((3,) + shp, 1e-4)))
    ice.step()
    got = convert.exports_to_numpy(ice.export_fields())
    jice = JCoupledIce(jbox(N, N).with_overrides(**over),
                       scale_fluxes=scale)
    jm = jice.model
    jm.state = _jax_state(convert.state_to_numpy(ice.model.state))
    jm.flux = _jax_flux(convert.fluxout_to_numpy(ice.model.flux))
    jm.forcing = _jax_forcing(ice.model.forcing)
    jice.Qa_iso = jnp.asarray(ice.Qa_iso.numpy())
    ref = {k: np.asarray(v) for k, v in jice.export_fields().items()}
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        scale_k = max(float(np.abs(ref[k]).max()), 1e-300)
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=1e-15 * scale_k, err_msg=k)
    assert float(np.abs(ref["Fioi_bcpho"]).max()) > 0
    assert float(ref["Si_ifrac"].max()) > 0.5


# -- reference faults 1 and 2 ----------------------------------------------

@pytest.mark.parametrize("dtype", [
    "float64", pytest.param("float32", marks=pytest.mark.slow)])
def test_the_coupled_step_runs_on_the_imports(monkeypatch, dtype):
    """Fault 1. The JAX package's coupled step (box2001) calls get_forcing,
    which replaces the imported winds; the port's equals the JAX package's
    model_step on the JAX package's imported Forcing. The age tendency of
    the dynamics is rounding residue here (ages of one step, differenced
    and divided by dt: ~1e-16): it takes a floor of 1e-15."""
    monkeypatch.setitem(ts.FLOORS, "dagedtd", (1e-15, 1e-3))
    cfg_over = {"dtype": dtype, "dynamics.ndte": 40,
                "setup.conserv_check": True}
    tice = CoupledIce(tbox(N, N).with_overrides(**cfg_over), device="cpu")
    jice = JCoupledIce(jbox(N, N).with_overrides(**cfg_over))
    shp = tice.model.grid.shape
    # imports in the run's dtype: the JAX package takes the wind speed in
    # the dtype it is given
    fields = {k: v.astype(dtype) for k, v in _imports(shp).items()}
    tice.import_fields(fields)
    jice.import_fields(fields)
    used = tice.coupled_forcing()
    start = convert.state_to_numpy(tice.model.state)
    jfc = jice.model.forcing.replace(
        yday=jnp.asarray(used.yday.numpy()),
        coszen=jnp.asarray(used.coszen.numpy()))
    ref_state, ref_flux = jdriver._model_step_jit(
        jice.model.static, jice.model.grid, _jax_state(start), jfc,
        dt=jice.model.cfg.setup.dt)
    tice.step()
    ts._compare(convert.state_to_numpy(tice.model.state),
                ts._tree(ref_state), "coupled step state", dtype)
    ts._compare(convert.fluxout_to_numpy(tice.model.flux),
                ts._tree(ref_flux), "coupled step flux", dtype)
    np.testing.assert_array_equal(tice.model.forcing.uatm.numpy(),
                                  fields["Sa_u"])
    assert float(np.abs(ref_state.uvel).max()) > 1e-3       # ice moves

    # the JAX package's own coupled step: box2001 winds, not the imports
    jice.model.state = _jax_state(start)
    jice.step()
    jf = jice.model.forcing
    assert float(np.abs(np.asarray(jf.uatm) - fields["Sa_u"]).max()) > 1.0
    du = np.abs(np.asarray(jice.model.state.uvel) -
                np.asarray(ref_state.uvel)).max()
    assert du > 1e-3 * float(np.abs(ref_state.uvel).max())


@pytest.mark.parametrize("tfrz", ["mushy", "linear_salt", "minus1p8"])
def test_imported_salinity_sets_the_freezing_point(tfrz):
    """Fault 2. The JAX package keeps Tf at the default 34 psu after an
    imported So_s; the port derives it from the import."""
    over = {"dtype": "float64", "thermo.tfrz_option": tfrz}
    tice = CoupledIce(tbox(N, N).with_overrides(**over), device="cpu")
    jice = JCoupledIce(jbox(N, N).with_overrides(**over))
    shp = tice.model.grid.shape
    sss = 28.0 + 6.0 * np.random.default_rng(1).random(shp)
    jtf_before = np.asarray(jice.model.forcing.Tf)
    tice.import_fields({"So_s": sss})
    jice.import_fields({"So_s": sss})
    want = np.asarray(jtf(jnp.asarray(sss), tfrz))
    np.testing.assert_allclose(tice.model.forcing.Tf.numpy(), want,
                               rtol=1e-15, atol=1e-15)
    np.testing.assert_array_equal(np.asarray(jice.model.forcing.Tf),
                                  jtf_before)            # stale
    if tfrz != "minus1p8":
        assert float(np.abs(want - jtf_before).max()) > 1e-2
