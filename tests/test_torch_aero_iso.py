"""PyTorch port vs JAX package: aerosols and water isotopes in snow and ice
(cice_tpu_torch/columns/aero_iso.py against cice_tpu/columns/aero_iso.py)
on the same numpy inputs made from a seed (ncat=5, 12x10 cells, CPU):
deposition into snow or bare ice, melt scavenging, snow-ice transfer and
the fluxes to the ocean, with the standalone deposition defaults and with
the coupler's per-species rates; the tables the port keeps its own copies
of; and two coupled steps of the `modal` option set against the JAX
package's model_step.

The JAX reference runs op by op (jax.disable_jit): jitted XLA contracts
float32 a*b+c into fused multiply-adds.

Tolerances: f64, 1e-13 of each field's largest value (the same elementwise
expressions in the same order; the category sum of the fluxes may sum in
another order); f32, 1e-6 of each field's largest value (an ulp or two of
the same operations).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.columns import aero_iso as jai  # noqa: E402
from cice_tpu.columns import dedd as jdedd  # noqa: E402
from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu_torch.columns import aero_iso as tai  # noqa: E402
from cice_tpu_torch.columns import dedd as tdedd  # noqa: E402
from cice_tpu_torch.config import Config as TConfig  # noqa: E402

NCAT, NY, NX = 5, 10, 12
DT = 3600.0
RTOL = {"float64": 1e-13, "float32": 1e-6}


def _close(got, ref, what, dtype):
    g, r = got.numpy(), np.asarray(ref)
    assert g.shape == r.shape and g.dtype == r.dtype, what
    scale = max(float(np.abs(r).max()), 1e-300)
    np.testing.assert_allclose(g, r, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * scale, err_msg=what)


def _inputs(rng, dtype, n_aero, n_iso):
    shp = (NCAT, NY, NX)
    aicen = np.where(rng.random(shp) < 0.2, 0.0, 0.05 + 0.3 * rng.random(shp))
    # bare ice (hs = 0), thin snow and deep snow
    hs = np.where(rng.random(shp) < 0.3, 0.0, 0.5 * rng.random(shp))
    hs[0, 0, :4] = 1e-13                     # hs at the puny knife edge
    a = dict(
        aicen=aicen, vicen=aicen * (0.1 + 3.0 * rng.random(shp)),
        vsnon=aicen * hs,
        aerosno=1e-6 * rng.random((NCAT, 2 * n_aero, NY, NX)),
        aeroice=1e-6 * rng.random((NCAT, 2 * n_aero, NY, NX)),
        isosno=rng.random((NCAT, n_iso, NY, NX)),
        isoice=rng.random((NCAT, n_iso, NY, NX)),
        melts=np.where(rng.random(shp) < 0.5, 0.0, 0.05 * rng.random(shp)),
        meltt=np.where(rng.random(shp) < 0.5, 0.0, 0.05 * rng.random(shp)),
        snoice=np.where(rng.random(shp) < 0.7, 0.0, 0.03 * rng.random(shp)),
        fsnow=3e-5 * rng.random((NY, NX)),
        faero_atm=1e-10 * rng.random((n_aero, NY, NX)),
        fiso_atm=3e-5 * rng.random((n_iso, NY, NX)))
    return {k: v.astype(dtype) for k, v in a.items()}


def _cfgs(n_aero, n_iso):
    over = {"tracers.tr_aero": True, "domain.n_aero": n_aero,
            "tracers.tr_iso": True, "domain.n_iso": n_iso}
    return TConfig().with_overrides(**over), JConfig().with_overrides(**over)


def test_tables_equal_jax():
    assert tai.KSCAV == jai.KSCAV
    assert tai.FAERO_DEFAULT == jai.FAERO_DEFAULT
    assert tai.ALPHA_DEP == jai.ALPHA_DEP
    assert tdedd.AER_OPTICS == jdedd.AER_OPTICS
    assert tdedd.MODAL_BC_ENHANCE == jdedd.MODAL_BC_ENHANCE


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n_aero,coupler", [(3, False), (6, False),
                                            (3, True)],
                         ids=["defaults", "six_species", "coupler"])
def test_step_aerosols_matches_jax(dtype, n_aero, coupler):
    a = _inputs(np.random.default_rng(60), dtype, n_aero, 1)
    tcfg, jcfg = _cfgs(n_aero, 1)
    keys = ("aicen", "vicen", "vsnon", "aerosno", "aeroice", "melts",
            "meltt", "snoice", "fsnow")
    with jax.disable_jit():
        ref = jai.step_aerosols(
            jcfg, DT, **{k: jnp.asarray(a[k]) for k in keys},
            faero_atm=jnp.asarray(a["faero_atm"]) if coupler else None)
    got = tai.step_aerosols(
        tcfg, DT, **{k: torch.as_tensor(a[k]) for k in keys},
        faero_atm=torch.as_tensor(a["faero_atm"]) if coupler else None)
    for g, r, what in zip(got, ref, ("aerosno", "aeroice", "faero_ocn")):
        _close(g, r, f"{what} n_aero={n_aero} coupler={coupler}", dtype)
    assert float(np.asarray(ref[2]).max()) > 0.0      # scavenged to ocean


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("coupler", [False, True], ids=["snowfall",
                                                        "coupler"])
def test_step_isotopes_matches_jax(dtype, coupler):
    a = _inputs(np.random.default_rng(61), dtype, 1, 3)
    tcfg, jcfg = _cfgs(1, 3)
    keys = ("aicen", "vsnon", "isosno", "isoice", "fsnow", "melts",
            "snoice")
    with jax.disable_jit():
        ref = jai.step_isotopes(
            jcfg, DT, **{k: jnp.asarray(a[k]) for k in keys},
            fiso_atm=jnp.asarray(a["fiso_atm"][:2]) if coupler else None)
    got = tai.step_isotopes(
        tcfg, DT, **{k: torch.as_tensor(a[k]) for k in keys},
        fiso_atm=torch.as_tensor(a["fiso_atm"][:2]) if coupler else None)
    for g, r, what in zip(got, ref, ("isosno", "isoice", "fiso_ocn")):
        _close(g, r, f"{what} coupler={coupler}", dtype)
    assert float(np.asarray(ref[2]).max()) > 0.0      # scavenged to ocean


def test_no_species_returns_empty_fluxes():
    a = _inputs(np.random.default_rng(62), "float64", 1, 1)
    tcfg = TConfig()
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    sn, ic, f = tai.step_aerosols(
        tcfg, DT, aicen=t["aicen"], vicen=t["vicen"], vsnon=t["vsnon"],
        aerosno=t["aerosno"], aeroice=t["aeroice"], melts=t["melts"],
        meltt=t["meltt"], snoice=t["snoice"], fsnow=t["fsnow"])
    assert sn is t["aerosno"] and ic is t["aeroice"]
    assert f.shape == (0, NY, NX)


def test_modal_two_steps_match_jax_f64(tmp_path):
    """Two coupled steps of gx1pop_step with the `modal` option set
    (aerosols with modal optics in delta-Eddington) against the JAX
    package's model_step, with history: tests/test_torch_column_steps.py's
    harness and tolerances (f64 rtol 1e-8 with floors, or 50 times the JAX
    package's own 1e-15 envelope)."""
    import test_torch_column_steps as tcs
    from cice_tpu_torch.cli import main as tcli
    run = tcs._run_pair("modal", "float64", tmp_path,
                        dict(tcli.OPTION_SETS["modal"]))
    tcs._check_steps(run)
    st, fl = run["ref"][-1]
    assert float(st["trcrn.aerosno"].max()) > 0.0          # deposition
    assert "ncat_fluxes.faero_ocn" in fl
    names = [f.name for f in run["tm"].history.streams[0].fields]
    assert names == [f.name for f in run["jm"].history.streams[0].fields]
    assert "faero_atm001" in names and "aerosnossl003" in names
