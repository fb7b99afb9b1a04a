"""PyTorch port vs JAX package: the skeletal-layer biogeochemistry
(cice_tpu_torch/columns/zbgc.py against cice_tpu/columns/zbgc.py) on the
same numpy inputs made from a seed (ncat=5, 12x10 cells, CPU): the piston
velocity of both flux types, the two-tracer model, and the full network
with every pool the registry can hold (three algal classes, ammonium,
silicate, the sulfur chain, PON, DON, the carbon pools, two iron classes,
humics) and with nitrate alone.

The JAX reference runs op by op (jax.disable_jit): jitted XLA contracts
float32 a*b+c into fused multiply-adds.

Tolerances: f64, 1e-13 of each field's largest value (the same elementwise
expressions in the same order; the category sums of the fluxes may sum in
another order); f32, 1e-6 of each field's largest value.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.columns import zbgc as jz  # noqa: E402
from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu_torch.columns import zbgc as tz  # noqa: E402
from cice_tpu_torch.config import Config as TConfig  # noqa: E402

NCAT, NY, NX = 5, 10, 12
DT = 3600.0
RTOL = {"float64": 1e-13, "float32": 1e-6}
FULL = {"zbgc.skl_bgc": True, "zbgc.n_algae": 3, "zbgc.tr_bgc_Am": True,
        "zbgc.tr_bgc_Sil": True, "zbgc.tr_bgc_DMS": True,
        "zbgc.tr_bgc_PON": True, "zbgc.tr_bgc_DON": True,
        "zbgc.tr_bgc_Fe": True, "zbgc.tr_bgc_C": True, "zbgc.n_doc": 3,
        "zbgc.n_dic": 1, "zbgc.n_fed": 2, "zbgc.n_fep": 2,
        "zbgc.tr_bgc_hum": True}
NAMES = ("bgc_N", "bgc_N2", "bgc_N3", "bgc_Nit", "bgc_Am", "bgc_Sil",
         "bgc_DMSPp", "bgc_DMSPd", "bgc_DMS", "bgc_PON", "bgc_DON",
         "bgc_DOC1", "bgc_DOC2", "bgc_DOC3", "bgc_DIC1", "bgc_Fed",
         "bgc_Fep", "bgc_Fed2", "bgc_Fep2", "bgc_hum")


def _close(got, ref, what, dtype):
    g, r = got.numpy(), np.asarray(ref)
    assert g.shape == r.shape and g.dtype == r.dtype, what
    scale = max(float(np.abs(r).max()), 1e-300)
    np.testing.assert_allclose(g, r, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * scale, err_msg=what)


def _forcing(rng, dtype):
    shp = (NCAT, NY, NX)
    a = dict(
        aicen=np.where(rng.random(shp) < 0.2, 0.0,
                       0.05 + 0.3 * rng.random(shp)),
        fswthru=np.where(rng.random(shp) < 0.2, 0.0, 40.0 * rng.random(shp)),
        Tbot=-1.8 + 0.3 * rng.random((1, NY, NX)),
        meltb=np.where(rng.random(shp) < 0.5, 0.0, 0.05 * rng.random(shp)),
        congel=np.where(rng.random(shp) < 0.5, 0.0, 0.02 * rng.random(shp)))
    return {k: v.astype(dtype) for k, v in a.items()}


@pytest.mark.parametrize("flux_type", ["Jin2006", "constant"])
def test_piston_velocity_matches_jax(flux_type):
    a = _forcing(np.random.default_rng(90), "float64")
    tcfg = TConfig().with_overrides(**{"zbgc.bgc_flux_type": flux_type})
    jcfg = JConfig().with_overrides(**{"zbgc.bgc_flux_type": flux_type})
    ref = jz._piston_velocity(jcfg.zbgc, jnp.asarray(a["congel"]),
                              jnp.asarray(a["meltb"]), DT)
    got = tz._piston_velocity(tcfg.zbgc, torch.as_tensor(a["congel"]),
                              torch.as_tensor(a["meltb"]), DT)
    if flux_type == "constant":
        assert got == ref
    else:
        _close(got, ref, "pv", "float64")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_step_bgc_skl_matches_jax(dtype):
    rng = np.random.default_rng(91)
    a = _forcing(rng, dtype)
    shp = (NCAT, NY, NX)
    a.update(vicen=a["aicen"] * 2.0,
             bgc_N=(5.0 * rng.random(shp)).astype(dtype),
             bgc_Nit=(12.0 * rng.random(shp)).astype(dtype),
             nit_ocn=np.full((NY, NX), 10.0, dtype))
    cfg_t, cfg_j = TConfig().zbgc, JConfig().zbgc
    with jax.disable_jit():
        ref = jz.step_bgc_skl(cfg_j, DT, **{k: jnp.asarray(v)
                                            for k, v in a.items()})
    got = tz.step_bgc_skl(cfg_t, DT, **{k: torch.as_tensor(v)
                                        for k, v in a.items()})
    for name in ("bgc_N", "bgc_Nit", "flux_NO3_ocn", "grow_net"):
        _close(getattr(got, name), getattr(ref, name), name, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("which", ["full", "nitrate_only", "no_nitrate"])
def test_step_bgc_skl_net_matches_jax(dtype, which):
    rng = np.random.default_rng(92)
    a = _forcing(rng, dtype)
    over = FULL if which == "full" else {"zbgc.skl_bgc": True}
    names = {"full": NAMES, "nitrate_only": ("bgc_N", "bgc_Nit"),
             "no_nitrate": ("bgc_N", "bgc_Am", "bgc_PON")}[which]
    z_t = TConfig().with_overrides(**over).zbgc
    z_j = JConfig().with_overrides(**over).zbgc
    shp = (NCAT, NY, NX)
    trc = {n: (8.0 * rng.random(shp)).astype(dtype) for n in names}
    ocean = {"bgc_Nit": 10.0, "bgc_Am": 1.0, "bgc_Sil": 25.0,
             "bgc_DMSPd": 0.1, "bgc_DMS": 0.1, "bgc_DON": 0.0,
             "bgc_hum": 1.0, "bgc_Fed": 0.5, "bgc_Fed2": 0.5,
             "bgc_DOC1": 16.2, "bgc_DOC2": 16.2, "bgc_DOC3": 16.2,
             "bgc_DIC1": 1950.0}
    with jax.disable_jit():
        ref = jz.step_bgc_skl_net(
            z_j, DT, **{k: jnp.asarray(v) for k, v in a.items()},
            trc={k: jnp.asarray(v) for k, v in trc.items()}, ocean=ocean)
    got = tz.step_bgc_skl_net(
        z_t, DT, **{k: torch.as_tensor(v) for k, v in a.items()},
        trc={k: torch.as_tensor(v) for k, v in trc.items()}, ocean=ocean)
    for part in ("trc", "flux_bgc_ocn"):
        g, r = getattr(got, part), getattr(ref, part)
        assert list(g) == list(r), part
        for k in r:
            _close(g[k], r[k], f"{which} {part} {k}", dtype)
    for name in ("grow_net", "upNO", "upNH", "PP_net"):
        _close(getattr(got, name), getattr(ref, name), name, dtype)


def test_tables_equal_jax():
    for k in ("SK_L", "CHLABS", "R_SI2N", "R_S2N", "R_C2N",
              "ALGAL_CLASSES"):
        assert getattr(tz, k) == getattr(jz, k), k
