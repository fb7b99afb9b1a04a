"""PyTorch port vs JAX package: delta-Eddington shortwave
(cice_tpu_torch/columns/dedd.py against cice_tpu/columns/dedd.py) and the
exposed pond fraction it reads, on the same numpy inputs made from a seed
(ncat=5, 24x16 cells, CPU): snow-covered, bare and ponded sub-columns,
thin and thick ice, low and high sun, and a dark half.

The port runs the three bands on a leading dimension; every element sees
the JAX package's operations in its order.

The JAX reference runs op by op (jax.disable_jit): jitted XLA contracts
float32 a*b+c into fused multiply-adds, which moves the float32 result by
5e-4 of its largest value through the adding recursions, and compiling the
twenty-layer recursion takes half a minute per case.

Tolerances: f64, 1e-12 of each field's largest value (no iteration: the
~1e-16 math-library differences of exp/sqrt pass through the adding
recursions); f32, 1e-5 of each field's largest value (a few ulp of the
float32 exp/sqrt through some twenty layers).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.columns import dedd as jdedd  # noqa: E402
from cice_tpu.columns import ponds as jponds  # noqa: E402
from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.columns import dedd as tdedd  # noqa: E402
from cice_tpu_torch.columns import ponds as tponds  # noqa: E402
from cice_tpu_torch.config import Config as TConfig  # noqa: E402

NCAT, NY, NX, NILYR = 5, 16, 24, 7
RTOL = {"float64": 1e-12, "float32": 1e-5}


def _inputs(rng, dtype):
    shp = (NCAT, NY, NX)
    kind = rng.integers(0, 4, shp)
    hi = np.where(kind == 0, 0.02 + 0.1 * rng.random(shp),
                  0.2 + 3.0 * rng.random(shp))
    hs = np.where(kind == 1, 0.0, 0.4 * rng.random(shp))
    hpnd = np.where(kind >= 2, 0.3 * rng.random(shp), 0.0)
    apeff = np.where(kind >= 2, 0.6 * rng.random(shp), 0.0)
    Tsf = np.where(rng.random(shp) > 0.5, 0.0, -20.0 * rng.random(shp))
    dark = np.arange(NX)[None, :] < NX // 4
    r = lambda hi_: hi_ * rng.random((NY, NX)) * ~dark
    a = dict(Tsf=Tsf, hi=hi, hs=hs, hpnd=hpnd, apeff=apeff,
             swvdr=r(200.0), swvdf=r(90.0), swidr=r(180.0), swidf=r(80.0),
             coszen=np.where(dark, -0.2, rng.random((NY, NX))))
    return {k: v.astype(dtype) for k, v in a.items()}


def _close_tree(got, ref, what, rtol):
    g, r = convert.tree_to_numpy(got), convert.tree_to_numpy(ref)
    assert g.keys() == r.keys(), what
    for k in r:
        a, b = np.asarray(g[k]), np.asarray(r[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        scale = max(float(np.abs(b).max()), 1e-300)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("tuning", [{}, {"R_ice": 1.0, "R_pnd": -1.0,
                                         "R_snw": 0.5}],
                         ids=["default", "tuned"])
def test_shortwave_dEdd_matches_jax(dtype, tuning):
    a = _inputs(np.random.default_rng(50), dtype)
    names = ("Tsf", "hi", "hs", "hpnd", "apeff", "swvdr", "swvdf", "swidr",
             "swidf", "coszen")
    jsw = JConfig().shortwave.replace(**tuning)
    tsw = TConfig().shortwave.replace(**tuning)
    with jax.disable_jit():
        ref = jdedd.shortwave_dEdd(*[jnp.asarray(a[n]) for n in names], jsw,
                                   NILYR, 1)
    got = tdedd.shortwave_dEdd(*[torch.as_tensor(a[n]) for n in names], tsw,
                               NILYR, 1)
    _close_tree(got, ref, f"dEdd {dtype} {tuning}", RTOL[dtype])
    alv = np.asarray(ref.alvdr)
    assert alv.max() > 0.8 and alv.min() < 0.5       # snow and ponds
    assert float(np.asarray(ref.fswthru).max()) > 0.0
    assert float(np.asarray(ref.fswsfc)[..., :NX // 4].max()) == 0.0


def test_dEdd_with_several_snow_layers_matches_jax():
    a = _inputs(np.random.default_rng(51), "float64")
    names = ("Tsf", "hi", "hs", "hpnd", "apeff", "swvdr", "swvdf", "swidr",
             "swidf", "coszen")
    ref = jdedd.shortwave_dEdd(*[jnp.asarray(a[n]) for n in names],
                               JConfig().shortwave, 4, 3)
    got = tdedd.shortwave_dEdd(*[torch.as_tensor(a[n]) for n in names],
                               TConfig().shortwave, 4, 3)
    _close_tree(got, ref, "dEdd nilyr=4 nslyr=3", RTOL["float64"])


def _aerosols_and_algae_against_jax(dtype, modal):
    """Snow aerosols (three species, SSL + interior loadings; modal_aero
    enhances BC absorption) darken the top snow layer on every band, and
    ice-algal chlorophyll shades the bottom ice layer in band 0 only."""
    rng = np.random.default_rng(52)
    a = _inputs(rng, dtype)
    names = ("Tsf", "hi", "hs", "hpnd", "apeff", "swvdr", "swvdf", "swidr",
             "swidf", "coszen")
    shp = (NCAT, NY, NX)
    aero = [(s * 1e-5 * rng.random(shp)).astype(dtype)
            for s in (1.0, 0.3, 50.0)]
    aero[0][0] = -1e-7                     # a negative loading clamps at 0
    tau_alg = (0.6 * rng.random(shp) - 0.1).astype(dtype)
    with jax.disable_jit():
        ref = jdedd.shortwave_dEdd(
            *[jnp.asarray(a[n]) for n in names], JConfig().shortwave, NILYR,
            2, aero_snow=[jnp.asarray(x) for x in aero], modal_aero=modal,
            tau_alg=jnp.asarray(tau_alg))
        clean = jdedd.shortwave_dEdd(*[jnp.asarray(a[n]) for n in names],
                                     JConfig().shortwave, NILYR, 2)
    got = tdedd.shortwave_dEdd(
        *[torch.as_tensor(a[n]) for n in names], TConfig().shortwave, NILYR,
        2, aero_snow=[torch.as_tensor(x) for x in aero], modal_aero=modal,
        tau_alg=torch.as_tensor(tau_alg))
    _close_tree(got, ref, f"dEdd aerosols + algae {dtype} modal={modal}",
                RTOL[dtype])
    # the terms act: darker snow, less light through the ice
    assert float(np.asarray(ref.alvdr).mean()) < \
        float(np.asarray(clean.alvdr).mean())
    assert float(np.asarray(ref.fswthru).sum()) < \
        float(np.asarray(clean.fswthru).sum())


def test_aerosols_and_algae_in_dEdd_raise_naming_the_roadmap():
    """(Kept name: the terms raised until they were ported.) The aerosol
    and algae terms of dEdd match the JAX package in f64, bulk and modal
    aerosol optics."""
    for modal in (False, True):
        _aerosols_and_algae_against_jax("float64", modal)


@pytest.mark.parametrize("modal", [False, True], ids=["bulk", "modal"])
def test_aerosols_and_algae_in_dEdd_match_jax_f32(modal):
    _aerosols_and_algae_against_jax("float32", modal)


@pytest.mark.parametrize("scheme", ["lvl", "topo", "sealvl"])
def test_pond_exposure_matches_jax(scheme):
    rng = np.random.default_rng(53)
    shp = (NCAT, NY, NX)
    over = {"tracers.tr_pond_lvl": scheme == "lvl",
            "tracers.tr_pond_topo": scheme == "topo",
            "tracers.tr_pond_sealvl": scheme == "sealvl"}
    aicen = 0.2 * rng.random(shp) * (rng.random(shp) > 0.2)
    vsnon = aicen * 0.05 * rng.random(shp)
    trcrn = dict(alvl=rng.random(shp), apnd=0.5 * rng.random(shp),
                 hpnd=0.3 * rng.random(shp), ipnd=0.2 * rng.random(shp))
    ref = jponds.pond_exposure(
        JConfig().with_overrides(**over), aicen=jnp.asarray(aicen),
        vsnon=jnp.asarray(vsnon),
        trcrn={k: jnp.asarray(v) for k, v in trcrn.items()})
    got = tponds.pond_exposure(
        TConfig().with_overrides(**over), aicen=torch.as_tensor(aicen),
        vsnon=torch.as_tensor(vsnon),
        trcrn={k: torch.as_tensor(v) for k, v in trcrn.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-14,
                               atol=0.0)
    assert float(np.asarray(ref).max()) > 0.05
