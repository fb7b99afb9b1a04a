"""PyTorch port vs JAX package: the topographic and sea-level pond schemes
and their dispatch (cice_tpu_torch/columns/ponds.py against
cice_tpu/columns/ponds.py), on the same numpy inputs made from a seed
(ncat=5, 24x16 cells, f64 and f32, CPU): cold and melting surfaces, thin
and thick ice, ponds with and without lids, both refreezing options.

Tolerances: f64, 1e-12 of each field's largest value (no iteration);
f32, 1e-5 (a few ulp through the square roots and exponentials).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.columns import ponds as jponds  # noqa: E402
from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.columns import ponds as tponds  # noqa: E402
from cice_tpu_torch.config import Config as TConfig  # noqa: E402

NCAT, NY, NX = 5, 16, 24
DT = 3600.0
RTOL = {"float64": 1e-12, "float32": 1e-5}
SCHEMES = {
    "topo": {"tracers.tr_pond_lvl": False, "tracers.tr_pond_topo": True},
    "sealvl": {"tracers.tr_pond_lvl": False, "tracers.tr_pond_sealvl": True,
               "ponds.apnd_sl": 0.27, "ponds.tscale_pnd_drain": 0.5},
    "sealvl_cesm": {"tracers.tr_pond_lvl": False,
                    "tracers.tr_pond_sealvl": True, "ponds.frzpnd": "cesm"},
}


def _inputs(rng, dtype):
    shp = (NCAT, NY, NX)
    aicen = 0.19 * rng.random(shp) * (rng.random(shp) > 0.2)
    hin = 0.1 + 3.0 * rng.random(shp)
    hsn = np.where(rng.random(shp) > 0.5, 0.3 * rng.random(shp), 0.0)
    kw = dict(aicen=aicen, vicen=aicen * hin, vsnon=aicen * hsn,
              Tsf=np.where(rng.random(shp) > 0.5, 0.0,
                           -20.0 * rng.random(shp)),
              meltt=0.01 * rng.random(shp), melts=0.02 * rng.random(shp),
              frain=2e-5 * rng.random((NY, NX)), aice=aicen.sum(0))
    trcrn = dict(apnd=0.5 * rng.random(shp), hpnd=0.3 * rng.random(shp),
                 ipnd=np.where(rng.random(shp) > 0.5,
                               0.05 * rng.random(shp), 0.0))
    cast = lambda d: {k: v.astype(dtype) for k, v in d.items()}
    return cast(kw), cast(trcrn)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_step_ponds_options_match_jax(scheme, dtype):
    kw, trcrn = _inputs(np.random.default_rng(60), dtype)
    jcfg = JConfig().with_overrides(**SCHEMES[scheme])
    tcfg = TConfig().with_overrides(**SCHEMES[scheme])
    J = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    Tt = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    with jax.disable_jit():
        ref = jponds.step_ponds(jcfg, DT, trcrn=J(trcrn), return_diag=True,
                                **J(kw))
    got = tponds.step_ponds(tcfg, DT, trcrn=Tt(trcrn), return_diag=True,
                            **Tt(kw))
    g, r = convert.tree_to_numpy(got), convert.tree_to_numpy(ref)
    assert g.keys() == r.keys()
    for k in r:
        # (the JAX package's sea-level apnd = where(volp > puny, apnd_sl,
        # 0.0) takes float64 from two Python scalars when x64 is on, as in
        # this test process; the port keeps the state's dtype)
        a, b = np.asarray(g[k]), np.asarray(r[k]).astype(dtype)
        assert a.dtype == np.dtype(dtype), k
        scale = max(float(np.abs(b).max()), 1e-300)
        np.testing.assert_allclose(a, b, rtol=RTOL[dtype],
                                   atol=RTOL[dtype] * scale,
                                   err_msg=f"{scheme} {dtype}: {k}")
    # the scheme's own terms are exercised
    flush = np.asarray(ref[3]["dpnd_freebd"])
    assert flush.max() > 0.0
    if scheme == "sealvl":
        assert np.asarray(ref[3]["dpnd_expon"]).max() > 0.0
        np.testing.assert_array_equal(
            np.unique(np.asarray(ref[0]["apnd"])), [0.0, 0.27])
    mj = jponds.pond_reservoir_mass(ref[0], jnp.asarray(kw["aicen"]), False)
    mt = tponds.pond_reservoir_mass(got[0], torch.as_tensor(kw["aicen"]),
                                    False)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj),
                               rtol=RTOL[dtype],
                               atol=RTOL[dtype] * float(np.abs(mj).max()))
