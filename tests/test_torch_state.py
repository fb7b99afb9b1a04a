"""PyTorch port vs JAX package: tracer registry, remap flat table, and the
NumPy round trip the parity tests use to hand both packages identical
inputs (cice_tpu_torch.model.state, .dynamics.remap_exact, .convert)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cice_tpu.config import Config  # noqa: E402
from cice_tpu.core.grid import rectgrid as jrectgrid  # noqa: E402
from cice_tpu.dynamics import remap_exact as jrx  # noqa: E402
from cice_tpu.model import state as jstate  # noqa: E402
from cice_tpu.model.flux import zeros_forcing as jzeros_forcing  # noqa: E402
from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.core.halo import BC as TBC  # noqa: E402
from cice_tpu_torch.dynamics import remap_exact as trx  # noqa: E402
from cice_tpu_torch.model import state as tstate  # noqa: E402

OVERRIDES = [
    {},
    {"tracers.tr_snow": True, "tracers.tr_fsd": True, "domain.nfsd": 3},
    {"tracers.tr_pond_lvl": False, "tracers.tr_pond_topo": True,
     "tracers.tr_brine": True, "tracers.tr_aero": True, "domain.n_aero": 2},
    {"zbgc.skl_bgc": True, "zbgc.tr_bgc_DMS": True, "zbgc.tr_bgc_C": True,
     "zbgc.tr_bgc_Fe": True, "zbgc.n_algae": 3, "tracers.tr_iso": True,
     "domain.n_iso": 2},
]


@pytest.mark.parametrize("over", OVERRIDES)
def test_registry_and_flat_table_match_jax(over):
    jreg = jstate.tracer_registry(Config().with_overrides(**over))
    treg = tstate.tracer_registry(tconfig.Config().with_overrides(**over))
    assert [dataclasses.astuple(s) for s in treg] == \
        [dataclasses.astuple(s) for s in jreg]
    jt = jrx.build_flat_table(jreg)
    tt = trx.build_flat_table(treg)
    assert [dataclasses.astuple(f) for f in tt] == \
        [dataclasses.astuple(f) for f in jt]
    ja, ta = jrx._TableArrays(jt), trx._TableArrays(tt)
    for k in ("ttype", "par", "gpar", "has_p", "has_g", "has_dep", "lo",
              "hi"):
        np.testing.assert_array_equal(getattr(ta, k), getattr(ja, k), k)
    assert (ta.K1, ta.K2, ta.K3) == (ja.K1, ja.K2, ja.K3)


def test_default_table_has_25_tracers():
    """The slice's tracer stack: hi, hs and 23 registry layers."""
    tab = trx.build_flat_table(tstate.tracer_registry(tconfig.Config()))
    assert len(tab) == 25
    assert [f.ttype for f in tab].count(3) == 2        # hpnd/ipnd on apnd


def test_z_tracers_not_ported():
    """(Kept name: the z-tracer registry raised until it was ported.) The
    bgcz registry and flat table equal the JAX package's: 266 entries, the
    z tracers and their mobile fractions of type 3 on vice -> fbri."""
    over = {"zbgc.z_tracers": True, "zbgc.solve_zbgc": True,
            "tracers.tr_brine": True, "domain.nblyr": 7,
            "zbgc.tr_bgc_Am": True, "zbgc.tr_bgc_Sil": True,
            "zbgc.tr_bgc_DMS": True, "zbgc.tr_bgc_PON": True,
            "zbgc.tr_bgc_DON": True, "zbgc.tr_bgc_Fe": True,
            "zbgc.tr_bgc_C": True, "zbgc.n_doc": 2, "zbgc.n_dic": 1,
            "zbgc.n_algae": 3}
    test_registry_and_flat_table_match_jax(over)
    tab = trx.build_flat_table(tstate.tracer_registry(
        tconfig.Config().with_overrides(**over)))
    assert len(tab) == 266
    assert [f.ttype for f in tab].count(3) == 226


def _jax_state(cfg, grid, rng):
    s = jstate.zeros_state(cfg, grid)
    rnd = lambda a: rng.standard_normal(np.shape(a)).astype(
        np.asarray(a).dtype)
    kw = {f.name: rnd(getattr(s, f.name)) for f in dataclasses.fields(s)
          if f.name not in ("trcrn", "iceUmask")}
    kw["iceUmask"] = rng.random(grid.shape) > 0.5
    kw["trcrn"] = {k: rnd(v) for k, v in s.trcrn.items()}
    return s.replace(**kw)


def _to_numpy(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, dict):
            out[f.name] = {k: np.asarray(x) for k, x in v.items()}
        elif f.name not in ("bc", "nx_global", "ny_global"):
            out[f.name] = np.asarray(v)
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_round_trip_is_exact(dtype):
    """JAX pytree -> numpy -> torch -> numpy returns the input exactly."""
    import jax.numpy as jnp
    cfg = Config().with_overrides(dtype=dtype)
    grid = jrectgrid(12, 10, dtype=jnp.dtype(dtype))
    rng = np.random.default_rng(11)
    st = _to_numpy(_jax_state(cfg, grid, rng))
    back = convert.state_to_numpy(convert.state_from_numpy(st, "cpu"))
    assert back.keys() == st.keys()
    for k, v in st.items():
        if k == "trcrn":
            for n in v:
                assert back[k][n].dtype == v[n].dtype
                np.testing.assert_array_equal(back[k][n], v[n])
        else:
            assert back[k].dtype == v.dtype, k
            np.testing.assert_array_equal(back[k], v, k)

    gd = _to_numpy(grid)
    tg = convert.grid_from_numpy(gd, TBC(grid.bc.ew, grid.bc.ns), "cpu")
    assert tg.shape == grid.shape
    for k, v in convert.grid_to_numpy(tg).items():
        np.testing.assert_array_equal(v, gd[k], k)

    fc = _to_numpy(jzeros_forcing(grid.shape, jnp.dtype(dtype)))
    fc = {k: (v + rng.standard_normal(v.shape)).astype(v.dtype)
          for k, v in fc.items()}
    for k, v in convert.forcing_to_numpy(
            convert.forcing_from_numpy(fc, "cpu")).items():
        assert v.dtype == fc[k].dtype
        np.testing.assert_array_equal(v, fc[k], k)


@pytest.mark.parametrize("over", OVERRIDES)
def test_set_state_var_matches_jax(over):
    """The driver's default initial state (ice poleward of 60 degrees,
    parabolic ITD, enthalpy profiles) for every registry above, f64."""
    import jax.numpy as jnp
    from cice_tpu.model.driver import set_state_var as jset
    from cice_tpu.model.forcing import default_ocn as jocn
    from cice_tpu_torch.core.grid import rectgrid as trect
    from cice_tpu_torch.model import driver as tdriver
    from cice_tpu_torch.model.flux import zeros_forcing as tzf
    from cice_tpu_torch.model.forcing import default_ocn as tocn
    over = dict(over, dtype="float64", **{"grid.nx_global": 12,
                                          "grid.ny_global": 40})
    jcfg = Config().with_overrides(**over)
    tcfg = tconfig.Config().with_overrides(**over)
    # a rect grid spanning ~45-90N so both the ice and open ocean appear
    kw = dict(dxrect_cm=30.0e5, dyrect_cm=1.5e7, latrefrect=40.0)
    jg = jrectgrid(12, 40, dtype=jnp.float64, **kw)
    tg = trect(12, 40, dtype=torch.float64, device="cpu", **kw)
    jtf = jocn(jg, jcfg, jzeros_forcing(jg.shape, jnp.float64)).Tf
    ttf = tocn(tg, tcfg, tzf(tg.shape, torch.float64, "cpu")).Tf
    js = _to_numpy(jset(jcfg, jg, jstate.zeros_state(jcfg, jg), jtf))
    ts = convert.state_to_numpy(tdriver.set_state_var(
        tcfg, tg, tstate.zeros_state(tcfg, tg), ttf))
    assert 0 < js["aicen"].sum() < js["aicen"].size
    for k in ("aicen", "vicen", "vsnon", "sst"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-14, atol=0, err_msg=k)
    assert ts["trcrn"].keys() == js["trcrn"].keys()
    for k, v in js["trcrn"].items():
        np.testing.assert_allclose(ts["trcrn"][k], v, rtol=1e-14, atol=0,
                                   err_msg=k)
