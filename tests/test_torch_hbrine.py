"""PyTorch port vs JAX package: the brine height tracer
(cice_tpu_torch/columns/hbrine.py against cice_tpu/columns/hbrine.py) on
the same numpy inputs made from a seed (ncat=5, 12x10 cells, CPU): the
growth and melt pre-adjustment, the permeability of the least liquid
layer, the Darcy relaxation toward sea level and the new-ice reset.

The JAX reference runs op by op (jax.disable_jit): jitted XLA contracts
float32 a*b+c into fused multiply-adds.

Tolerances: f64, 1e-12 of each field's largest value (the same
expressions; the mushy temperature inversion's sqrt and the exp of the
relaxation differ by ~1e-16 between math libraries); f32, 1e-5 of each
field's largest value (the inversion cancels near the liquidus: a few ulp
of T move phi_min, and perm ~ phi^3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.columns import hbrine as jhb  # noqa: E402
from cice_tpu.columns import mushy as jmushy  # noqa: E402
from cice_tpu_torch.columns import hbrine as thb  # noqa: E402

NCAT, NILYR, NY, NX = 5, 7, 10, 12
DT = 3600.0
RTOL = {"float64": 1e-12, "float32": 1e-5}


def _inputs(rng, dtype):
    shp = (NCAT, NY, NX)
    aicen = np.where(rng.random(shp) < 0.2, 0.0, 0.05 + 0.3 * rng.random(shp))
    lay = (NCAT, NILYR, NY, NX)
    S = 0.5 + 12.0 * rng.random(lay)
    T = -12.0 * rng.random(lay) ** 2 - 0.05
    with jax.disable_jit():
        q = np.asarray(jmushy.enthalpy_mush(jnp.asarray(T), jnp.asarray(S)))
    aicen[0, 0, :3] = 0.2
    fbri = np.where(aicen > 0, 0.05 + 1.3 * rng.random(shp), 0.0)
    fbri[0, 0, :3] = 0.0                     # new ice: fbri resets to 1
    a = dict(aicen=aicen, vicen=aicen * (0.1 + 2.5 * rng.random(shp)),
             vsnon=aicen * 0.4 * rng.random(shp), fbri=fbri, qice=q, sice=S,
             meltb=np.where(rng.random(shp) < 0.5, 0.0,
                            0.02 * rng.random(shp)),
             meltt=np.where(rng.random(shp) < 0.5, 0.0,
                            0.02 * rng.random(shp)),
             congel=np.where(rng.random(shp) < 0.5, 0.0,
                             0.02 * rng.random(shp)),
             frazil_n=0.01 * rng.random(shp))
    return {k: v.astype(dtype) for k, v in a.items()}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("frazil", [False, True], ids=["", "frazil"])
def test_update_hbrine_matches_jax(dtype, frazil):
    a = _inputs(np.random.default_rng(80), dtype)
    if not frazil:
        a.pop("frazil_n")
    with jax.disable_jit():
        ref = jhb.update_hbrine(DT, **{k: jnp.asarray(v)
                                       for k, v in a.items()})
    got = thb.update_hbrine(DT, **{k: torch.as_tensor(v)
                                   for k, v in a.items()})
    for name in ("fbri", "hbri", "darcy_V"):
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.dtype == r.dtype and g.shape == r.shape, name
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g, r, rtol=RTOL[dtype],
                                   atol=RTOL[dtype] * scale,
                                   err_msg=f"{name} {dtype}")
    fb = np.asarray(ref.fbri)
    assert (fb[0, 0, :3] == 1.0).all()                 # new-ice reset
    assert (np.asarray(ref.darcy_V) > 0).any() and \
        (np.asarray(ref.darcy_V) < 0).any()            # flood and drain
    assert thb.FBRI_MIN <= fb[a["aicen"] > 0].min()


def test_constants_equal_jax():
    for k in ("GRAVIT", "VISC_DYN", "PERM_SCALE", "PHI_SNOW", "FBRI_INIT",
              "FBRI_MIN", "FBRI_MAX"):
        assert getattr(thb, k) == getattr(jhb, k), k
