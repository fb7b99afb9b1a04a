"""PyTorch port vs JAX package: the mushy-layer thermodynamics
(cice_tpu_torch/columns/mushy.py against cice_tpu/columns/mushy.py) and the
ktherm=2 branch of temperature_changes, on the same numpy inputs made from
a seed (ncat=5, 24x16 cells, CPU).

Tolerances. f64: 1e-10 of each field's largest value (test_torch_thermo's:
the same expressions in the same order; the Picard solve amplifies the
~1e-16 math-library differences by a few orders at most). f32: the JAX
package's own tolerances for these functions, tests/test_mushy.py:22
(rtol 1e-5 on the liquidus round trip) and :33 (atol 1e-3 C on the
temperature inversion), taken here as 1e-5 of each field's largest value
and 1e-3 C. The salt budget of the gravity drainage closes to rtol 1e-5,
as tests/test_mushy.py:149 holds it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu import constants as jcst  # noqa: E402
from cice_tpu.columns import mushy as jm  # noqa: E402
from cice_tpu.columns import thermo_vertical as jtv  # noqa: E402
from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu_torch.columns import mushy as tm  # noqa: E402
from cice_tpu_torch.columns import thermo_vertical as ttv  # noqa: E402
from cice_tpu_torch.config import Config as TConfig  # noqa: E402
from test_torch_thermo import (DT, NILYR, NSLYR, NCAT, NX, NY, T,  # noqa: E402
                               _close, _close_tree, _map, _therm_args,
                               inputs)  # noqa: F401

F32 = {"rtol": 1e-5, "T_atol": 1e-3}


def _mush_inputs(rng, shape=(NCAT, NY, NX)):
    """Temperatures over both liquidus branches and the liquid, bulk
    salinities 0-40 g/kg, enthalpies of mush near and far from the
    liquidus."""
    Tc = np.concatenate([-0.05 - 3.0 * rng.random(shape[:1] + (NY // 2, NX)),
                         -2.0 - 30.0 * rng.random(shape[:1] + (NY // 2, NX))],
                        axis=1)
    S = 40.0 * rng.random(shape)
    return Tc, S


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_state_relations_match_jax(dtype):
    rng = np.random.default_rng(40)
    Tc, S = _mush_inputs(rng)
    Tc, S = Tc.astype(dtype), S.astype(dtype)
    f32 = dtype == "float32"
    rtol = F32["rtol"] if f32 else 1e-12
    J, TT = jnp.asarray, lambda a: torch.as_tensor(np.array(a))
    for name, args in (("liquidus_brine_salinity", (Tc,)),
                       ("liquidus_temperature", (S,)),
                       ("liquid_fraction", (Tc, S)),
                       ("enthalpy_brine", (Tc,)), ("enthalpy_solid", (Tc,)),
                       ("enthalpy_mush", (Tc, S)),
                       ("enthalpy_of_melting", (S,)),
                       ("conductivity_mush", (Tc, S)),
                       ("eff_heat_capacity_mush", (Tc, Tc - 0.3, S))):
        ref = jax.jit(getattr(jm, name))(*map(J, args))
        got = getattr(tm, name)(*map(TT, args))
        assert got.dtype == getattr(torch, dtype), name
        _close(got, ref, name, rtol)
    # the inversion: T of q(T, S), through the quadratic's negative root
    q = np.asarray(jm.enthalpy_mush(J(Tc), J(S)))
    ref = jax.jit(jm.temperature_mush)(J(q), J(S))
    got = tm.temperature_mush(TT(q), TT(S))
    if f32:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=F32["T_atol"])
    else:
        _close(got, ref, "temperature_mush", 1e-12)
        np.testing.assert_allclose(got.numpy(), Tc, atol=1e-8)
    # the liquid regime and the cold branch are both taken
    assert float(np.asarray(ref).max()) > -0.5
    assert float(np.asarray(ref).min()) < jm.T_JOIN


def test_new_ice_and_drainage_match_jax():
    rng = np.random.default_rng(41)
    shp = (NCAT, NY, NX)
    Tbot = -1.7 - 0.3 * rng.random((NY, NX))
    sss = 30.0 + 5.0 * rng.random((NY, NX))
    for phi in (0.85, 1.0, 0.5):
        ref = jm.new_ice_enthalpy_salinity(jnp.asarray(Tbot),
                                           jnp.asarray(sss), phi)
        got = tm.new_ice_enthalpy_salinity(T(Tbot), T(sss), phi)
        _close_tree(got, ref, f"new ice phi={phi}", 1e-12)
    # a column that drains in the rapid mode near the base and the slow
    # mode above: warm permeable mush over a saltier bottom
    S = [5.0 + 25.0 * rng.random(shp) * (k + 1) / NILYR
         for k in range(NILYR)]
    Tl = [-0.5 - 4.0 * rng.random(shp) * (NILYR - k) / NILYR
          for k in range(NILYR)]
    hilyr = (0.05 + 2.0 * rng.random(shp)) / NILYR
    for cfg in (JConfig().thermo,
                JConfig().thermo.replace(Rac_rapid_mode=1e9),
                JConfig().thermo.replace(a_rapid_mode=2e-3,
                                         dSdt_slow_mode=-1e-6)):
        tcfg = TConfig().thermo.replace(
            **{k: getattr(cfg, k) for k in (
                "a_rapid_mode", "Rac_rapid_mode", "aspect_rapid_mode",
                "dSdt_slow_mode", "phi_c_slow_mode")})
        kw = dict(S_layers=S, T_layers=Tl, hilyr=hilyr, sss=sss)
        ref = jax.jit(lambda a: jm.drain_salinity(
            cfg, DT, nilyr=NILYR, **a))(_map(jnp.asarray, kw))
        got = tm.drain_salinity(tcfg, DT, nilyr=NILYR, **_map(T, kw))
        _close_tree(got, ref, "drain_salinity", 1e-12)
        # salt budget: what leaves the layers reaches the ocean
        dS = sum((a - b) for a, b in zip(S, [x.numpy() for x in got[0]]))
        np.testing.assert_allclose(
            got[1].numpy(), dS * 1e-3 * jcst.rhoi * hilyr / DT, rtol=1e-5,
            atol=1e-5 * float(got[1].abs().max()))
        assert float(got[1].max()) > 0.0


def _mushy_therm_args(fc, col, rng):
    """temperature_changes inputs under ktherm=2: prognostic layer
    salinities, mushy enthalpies and liquidus melting temperatures."""
    kw = _therm_args(fc, col)
    shp = (NCAT, NY, NX)
    S = [2.0 + 8.0 * rng.random(shp) for _ in range(NILYR)]
    Tl = [np.asarray(jtv.temp_from_enthalpy_ice(jnp.asarray(q), Tm))
          for q, Tm in zip(col["qice"], col["Tm"])]
    kw["qice"] = [np.asarray(jm.enthalpy_mush(jnp.asarray(t), jnp.asarray(s)))
                  for t, s in zip(Tl, S)]
    return kw, S, [np.asarray(jm.liquidus_temperature(jnp.asarray(s)))
                   for s in S]


def test_temperature_changes_mushy_matches_jax(inputs):  # noqa: F811
    fc, col = inputs
    kw, S, Tm = _mushy_therm_args(fc, col, np.random.default_rng(42))
    static = dict(conduct="bubbly", nit=50, ktherm=2)
    ref = jax.jit(lambda a, s, t: jtv.temperature_changes(
        DT, NILYR, NSLYR, salin=s, Tm=t, **a, **static))(
            _map(jnp.asarray, kw), [jnp.asarray(x) for x in S],
            [jnp.asarray(x) for x in Tm])
    got = ttv.temperature_changes(DT, NILYR, NSLYR, salin=[T(x) for x in S],
                                  Tm=[T(x) for x in Tm], **_map(T, kw),
                                  **static)
    _close_tree(got, ref, "temperature_changes ktherm=2")
    ts = ref[0]
    assert float(np.asarray(ts.Tsf).max()) == 0.0        # melting closure
    assert float(np.asarray(ts.Tsf).min()) < -5.0
    # the port reads one scalar per Picard pass and nothing else
    reads = []
    orig = torch.Tensor.__bool__

    def counting(self):
        reads.append(1)
        return orig(self)
    torch.Tensor.__bool__ = counting
    try:
        ttv.temperature_changes(DT, NILYR, NSLYR, salin=[T(x) for x in S],
                                Tm=[T(x) for x in Tm], **_map(T, kw),
                                **static)
    finally:
        torch.Tensor.__bool__ = orig
    assert 1 <= len(reads) <= static["nit"]
