"""PyTorch port vs JAX package: mechanical redistribution
(columns/ridging `ridge_ice`) on the same numpy inputs made from a seed
(ncat=5, 24x16 cells, default tracers, f64, CPU), for a quiescent field,
moderate deformation and a convergence strong enough to need every pass.

Tolerance: f64, 1e-10 of each field's largest value (same expressions,
reduction order only). The pass loop's global exit test (some cell still
has closing left) must stop both packages after the same number of passes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.columns import itd as jitd  # noqa: E402
from cice_tpu.columns import ridging as jrdg  # noqa: E402
from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu.model.state import tracer_registry as jreg  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.columns import ridging as trdg  # noqa: E402
from cice_tpu_torch.config import Config as TConfig  # noqa: E402
from cice_tpu_torch.model.state import tracer_registry as treg  # noqa: E402

NCAT, NY, NX = 5, 16, 24
RTOL = 1e-10
JCFG, TCFG = JConfig(), TConfig()
JREG, TREG = jreg(JCFG), treg(TCFG)
HIN_MAX = jitd.category_bounds(NCAT, 1, 7, 1)


def T(a):
    return torch.as_tensor(np.array(a))


def _map(fn, d):
    return {k: fn(v) for k, v in d.items()}


def _close_tree(got, ref, what, rtol=RTOL):
    g, r = convert.tree_to_numpy(got), convert.tree_to_numpy(ref)
    assert g.keys() == r.keys(), (what, g.keys() ^ r.keys())
    for k in r:
        scale = max(float(np.abs(r[k]).max()), 1e-300)
        np.testing.assert_allclose(g[k], r[k], rtol=rtol, atol=rtol * scale,
                                   err_msg=f"{what}: {k}")


def _state(seed):
    rng = np.random.default_rng(seed)
    shp = (NCAT, NY, NX)
    lo = np.asarray(HIN_MAX[:-1])[:, None, None]
    hi = np.minimum(np.asarray(HIN_MAX[1:]), 8.0)[:, None, None]
    h = lo + (hi - lo) * (0.05 + 0.9 * rng.random(shp))
    aicen = 0.198 * rng.random(shp) * (rng.random(shp) > 0.2)
    vicen = aicen * h
    vsnon = aicen * 0.3 * rng.random(shp)
    fill = dict(Tsfcn=lambda s: -20.0 * rng.random(s),
                qice=lambda s: -2.5e8 * (1 + 0.2 * rng.random(s)),
                sice=lambda s: 5.0 * (1 + 0.1 * rng.random(s)),
                qsno=lambda s: -1.1e8 * (1 + 0.1 * rng.random(s)),
                iage=lambda s: 3.0e7 * rng.random(s))
    trcrn = {}
    for spec in JREG:
        s = shp[:1] + ((spec.nlayers,) if spec.nlayers else ()) + shp[1:]
        trcrn[spec.name] = fill.get(spec.name, rng.random)(s)
    return aicen, vicen, vsnon, trcrn, rng


# (divergence scale 1/s, dt s, passes the loop must take)
CASES = {"quiescent": (0.0, 3600.0, 1),
         "moderate": (2e-7, 3600.0, None),
         "strong": (4e-4, 3600.0, 3)}


@pytest.mark.parametrize("case", list(CASES))
def test_ridge_ice_matches_jax(case):
    amp, dt, npass = CASES[case]
    aicen, vicen, vsnon, trcrn, rng = _state(40)
    divu = amp * (rng.random((NY, NX)) - 0.7)
    Delta = np.abs(divu) + amp * rng.random((NY, NX))
    J = jnp.asarray
    ref = jax.jit(lambda a, v, s, t, d, D: jrdg.ridge_ice(
        JCFG, a, v, s, t, divu=d, Delta=D, dt=dt, hin_max=HIN_MAX,
        registry=JREG))(J(aicen), J(vicen), J(vsnon), _map(J, trcrn),
                        J(divu), J(Delta))
    got = trdg.ridge_ice(TCFG, T(aicen), T(vicen), T(vsnon), _map(T, trcrn),
                         divu=T(divu), Delta=T(Delta), dt=dt,
                         hin_max=HIN_MAX, registry=TREG)
    taken = got[4].pop("npass")
    if npass is not None:
        assert taken == npass
    _close_tree(got, ref, f"ridge_ice {case}")
    rd = ref[4]
    # at least one pass always runs: the participation snapshot exists
    assert float(np.asarray(rd["aparticn"]).max()) > 0.0
    if amp:
        assert float(np.asarray(rd["dardg1dt"]).max()) > 0.0
        assert float(np.asarray(rd["dvirdgdt"]).max()) > 0.0
    # ridging conserves ice volume up to what cleanup hands to the ocean
    lost = np.asarray(rd["fresh_cleanup"]) * dt
    mass0 = 917.0 * vicen.sum(0) + 330.0 * vsnon.sum(0)
    mass1 = 917.0 * got[1].sum(0).numpy() + 330.0 * got[2].sum(0).numpy()
    np.testing.assert_allclose(mass1 + lost, mass0, rtol=1e-10, atol=1e-9)


@pytest.mark.parametrize("kstrength", [0, 1])
def test_ice_strength_matches_jax(kstrength):
    aicen, vicen, _, _, _ = _state(41)
    jd = JCFG.with_overrides(**{"dynamics.kstrength": kstrength}).dynamics
    td = TCFG.with_overrides(**{"dynamics.kstrength": kstrength}).dynamics
    J = jnp.asarray
    ref = jrdg.ice_strength(J(aicen), J(vicen), J(aicen.sum(0)),
                            J(vicen.sum(0)), jd)
    got = trdg.ice_strength(T(aicen), T(vicen), T(aicen.sum(0)),
                            T(vicen.sum(0)), td)
    _close_tree(got, ref, "ice_strength")
