"""PyTorch port vs JAX package: the ITD-coupled thermodynamics on the same
numpy inputs made from a seed (ncat=5, 24x16 cells, default tracers, f64,
CPU): the linear ITD remap, `rebin` and `cleanup_itd` (columns/itd), frazil
formation and lateral melt (columns/thermo_itd) and `step_therm2` as a
whole, with the tracers given as a dict and as the packed stack.

Tolerance: f64, 1e-10 of each field's largest value (same expressions,
reduction order only). `rebin` merges tracers only when some parcel moves:
both packages must take the same branch, so a category that no parcel
enters keeps its tracers bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.columns import itd as jitd  # noqa: E402
from cice_tpu.columns import thermo_itd as jt2  # noqa: E402
from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu.model.state import tracer_registry as jreg  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.columns import itd as titd  # noqa: E402
from cice_tpu_torch.columns import thermo_itd as tt2  # noqa: E402
from cice_tpu_torch.config import Config as TConfig  # noqa: E402
from cice_tpu_torch.model.state import tracer_registry as treg  # noqa: E402

NCAT, NY, NX = 5, 16, 24
DT = 3600.0
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


def _state(seed, spill=0.0):
    """aicen/vicen/vsnon with each category's thickness inside its bounds
    (a fraction `spill` of cells pushed outside), some empty cells and
    knife-edge areas, and every default tracer filled."""
    rng = np.random.default_rng(seed)
    shp = (NCAT, NY, NX)
    lo = np.asarray(HIN_MAX[:-1])[:, None, None]
    hi = np.minimum(np.asarray(HIN_MAX[1:]), 8.0)[:, None, None]
    h = lo + (hi - lo) * (0.05 + 0.9 * rng.random(shp))
    out = rng.random(shp) < spill
    h = np.where(out, h * np.where(rng.random(shp) > 0.5, 1.9, 0.4), h)
    aicen = 0.19 * rng.random(shp) * (rng.random(shp) > 0.25)
    aicen = np.where(rng.random(shp) < 0.05, 1e-12, aicen)
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


def test_registries_agree():
    assert [(s.name, s.depend, s.nlayers) for s in JREG] == \
        [(s.name, s.depend, s.nlayers) for s in TREG]
    jd, jl = jitd.flat_dep_table(JREG)
    td, tl = titd.flat_dep_table(TREG)
    assert jl == tl and (jd == td).all()
    assert titd.name_offsets(TREG) == jitd.name_offsets(JREG)


@pytest.mark.parametrize("packed", [False, True])
def test_linear_itd_remap_matches_jax(packed):
    aicen, vicen, vsnon, trcrn, rng = _state(30)
    h_old = np.where(aicen > 1e-11, vicen / np.maximum(aicen, 1e-11), 0.0)
    h_new = np.maximum(h_old + 0.3 * (rng.random(h_old.shape) - 0.4), 0.01)
    h_new = np.where(aicen > 1e-11, h_new, 0.0)
    vicen = aicen * h_new
    J, N = jnp.asarray, np.asarray
    jtr = _map(J, trcrn)
    ttr = _map(T, trcrn)
    if packed:
        jtr, ttr = jitd.pack_tracers(jtr, JREG), titd.pack_tracers(ttr, TREG)
        np.testing.assert_array_equal(ttr.numpy(), N(jtr))
    ref = jax.jit(lambda a, v, s, t, ho, hn: jitd.linear_itd_remap(
        a, v, s, t, HIN_MAX, ho, hn, JREG))(
            J(aicen), J(vicen), J(vsnon), jtr, J(h_old), J(h_new))
    got = titd.linear_itd_remap(T(aicen), T(vicen), T(vsnon), ttr, HIN_MAX,
                                T(h_old), T(h_new), TREG)
    _close_tree(got, ref, "linear_itd_remap")
    assert float(np.abs(N(ref[0]) - aicen).max()) > 1e-3   # area moved
    np.testing.assert_allclose(got[0].sum(0).numpy(), aicen.sum(0),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("spill", [0.0, 0.2])
def test_rebin_matches_jax(spill):
    aicen, vicen, vsnon, trcrn, _ = _state(31, spill)
    J = jnp.asarray
    ref = jax.jit(lambda a, v, s, t: jitd.rebin(a, v, s, t, HIN_MAX, JREG))(
        J(aicen), J(vicen), J(vsnon), _map(J, trcrn))
    got = titd.rebin(T(aicen), T(vicen), T(vsnon), _map(T, trcrn), HIN_MAX,
                     TREG)
    _close_tree(got, ref, "rebin")
    if spill == 0.0:
        # no parcel moves: the merge is skipped, tracers pass untouched
        for k, v in got[3].items():
            np.testing.assert_array_equal(v.numpy(), trcrn[k], err_msg=k)
    else:
        assert float(np.abs(got[0].numpy() - aicen).max()) > 1e-3


@pytest.mark.parametrize("with_dt", [False, True])
def test_cleanup_itd_matches_jax(with_dt):
    aicen, vicen, vsnon, trcrn, _ = _state(32)
    aicen = aicen * 2.0        # some cells exceed aice = 1
    J = jnp.asarray
    kw = dict(dt=DT, sal_ref=4.0) if with_dt else {}
    ref = jitd.cleanup_itd(J(aicen), J(vicen), J(vsnon), _map(J, trcrn),
                           JREG, **kw)
    got = titd.cleanup_itd(T(aicen), T(vicen), T(vsnon), _map(T, trcrn),
                           TREG, **kw)
    assert len(got) == len(ref) == (5 if with_dt else 4)
    _close_tree(got, ref, "cleanup_itd")
    assert float(got[0].sum(0).max()) <= 1.0 + 1e-12
    _close_tree(titd.compute_tracers(got[0], got[1], got[2], got[3], TREG),
                jitd.compute_tracers(ref[0], ref[1], ref[2], ref[3], JREG),
                "compute_tracers")


def _ocean(rng):
    r = lambda lo, hi: lo + (hi - lo) * rng.random((NY, NX))
    half = (np.arange(NX)[None, :] >= NX // 2) * np.ones((NY, 1))
    return dict(frzmlt=np.where(half, r(5.0, 400.0), r(-400.0, -5.0)),
                Tf=np.full((NY, NX), -1.8),
                sst=np.where(half, -1.8, r(-1.7, 1.5)))


def test_add_new_ice_and_lateral_melt_match_jax():
    aicen, vicen, vsnon, trcrn, rng = _state(33)
    oc = _ocean(rng)
    J = jnp.asarray
    kw = dict(dt=DT, hin_max=HIN_MAX, nilyr=7, sal_ref=4.0)
    ref = jax.jit(lambda a, v, s, t, o: jt2.add_new_ice(
        a, v, s, t, frzmlt=o["frzmlt"], Tf=o["Tf"], registry=JREG, **kw))(
            J(aicen), J(vicen), J(vsnon), _map(J, trcrn), _map(J, oc))
    got = tt2.add_new_ice(T(aicen), T(vicen), T(vsnon), _map(T, trcrn),
                          frzmlt=T(oc["frzmlt"]), Tf=T(oc["Tf"]),
                          registry=TREG, **kw)
    _close_tree(got, ref, "add_new_ice")
    assert float(np.asarray(ref[3]).max()) > 1e-3          # frazil forms
    ref = jt2.lateral_melt(J(aicen), J(vicen), J(vsnon), _map(J, trcrn),
                           frzmlt=J(oc["frzmlt"]), Tbot=J(oc["Tf"]),
                           sst=J(oc["sst"]), Tf=J(oc["Tf"]), dt=DT,
                           registry=JREG, sal_ref=4.0)
    got = tt2.lateral_melt(T(aicen), T(vicen), T(vsnon), _map(T, trcrn),
                           frzmlt=T(oc["frzmlt"]), Tbot=T(oc["Tf"]),
                           sst=T(oc["sst"]), Tf=T(oc["Tf"]), dt=DT,
                           registry=TREG, sal_ref=4.0)
    _close_tree(got, ref, "lateral_melt")
    assert float(np.asarray(ref[3]).max()) > 0.0           # some melt


def test_step_therm2_matches_jax():
    aicen, vicen, vsnon, trcrn, rng = _state(34)
    oc = _ocean(rng)
    h_new = np.where(aicen > 1e-11, vicen / np.maximum(aicen, 1e-11), 0.0)
    h_old = np.maximum(h_new - 0.25 * (rng.random(h_new.shape) - 0.4), 0.0)
    J = jnp.asarray
    ref = jax.jit(lambda a, v, s, t, ho, o: jt2.step_therm2(
        JCFG, None, a, v, s, t, hicen_old=ho, frzmlt=o["frzmlt"], Tf=o["Tf"],
        sst=o["sst"], dt=DT, hin_max=HIN_MAX, registry=JREG))(
            J(aicen), J(vicen), J(vsnon), _map(J, trcrn), J(h_old),
            _map(J, oc))
    got = tt2.step_therm2(TCFG, None, T(aicen), T(vicen), T(vsnon),
                          _map(T, trcrn), hicen_old=T(h_old),
                          frzmlt=T(oc["frzmlt"]), Tf=T(oc["Tf"]),
                          sst=T(oc["sst"]), dt=DT, hin_max=HIN_MAX,
                          registry=TREG)
    _close_tree(got, ref, "step_therm2")
    for k in ("frazil", "meltl", "dpnd_melt"):
        assert float(np.asarray(getattr(ref, k)).max()) > 0.0, k
    assert np.isfinite(got.trcrn["qice"].numpy()).all()
