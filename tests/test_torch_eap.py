"""PyTorch port vs JAX package: the EAP rheology (cice_tpu_torch.dynamics.
eap): the yield-surface lookup tables, the anisotropic stress at one
corner, the structure-tensor source and the whole `eap_solve` with a
seeded structure tensor (a11, a12).

The tables are built by the same numpy code and must be equal. The JAX
reference runs under `jax.disable_jit()`: jitted, XLA contracts the
float32 table sums (t11r + KFRICTION * t11s + ...) into fused
multiply-adds, one float32 ulp away from the written sums (1e-7 of the
stresses), and the lookup, which truncates a float ratio to a table
index, turns that into neighbouring table entries within two subcycles
(5e-3 of the velocities). Op by op the JAX package computes what its
code says, and there the port agrees to 5e-16 in f64 and 3e-7 in f32.
Tolerances: f64 at rtol 1e-8 and f32 at the JAX package's 2e-3 of each
field's largest value.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.dynamics import common as jcommon  # noqa: E402
from cice_tpu.dynamics import eap as jeap  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.dynamics import common as tcommon  # noqa: E402
from cice_tpu_torch.dynamics import eap as teap  # noqa: E402

from test_torch_evp import _np, _preps, _problem  # noqa: E402

NDTE = 20


def _close(got, ref, rtol, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


def test_yield_tables_equal_the_reference():
    for a, b in zip(teap.yield_tables(), jeap.yield_tables()):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert any(np.abs(t).max() > 0.1 for t in teap.yield_tables())


def _corner_inputs(dtype, n=4000):
    rng = np.random.default_rng(17)
    d = dict(divu=1e-6 * rng.standard_normal(n),
             tension=1e-6 * rng.standard_normal(n),
             shear=1e-6 * rng.standard_normal(n),
             a11=0.5 + 0.5 * rng.random(n),
             a12=0.2 * rng.standard_normal(n),
             strength=2e4 * rng.random(n))
    # some exact zeros: the principal-axis and arctan guards
    d["shear"][:50] = 0.0
    d["tension"][:50] = 0.0
    d["a12"][:25] = 0.0
    d["a11"][:25] = 0.5
    return {k: v.astype(dtype) for k, v in d.items()}


def test_stress_rdg_and_calc_ffrac_f64():
    d = _corner_inputs("float64")
    jt = tuple(jnp.asarray(t) for t in jeap.yield_tables())
    J, T = jnp.asarray, torch.as_tensor
    keys = ("divu", "tension", "shear", "a11", "a12", "strength")
    ref = jeap.stress_rdg(*(J(d[k]) for k in keys), jt)
    got = teap.stress_rdg(*(T(d[k]) for k in keys),
                          teap._device_tables(torch.device("cpu")))
    for name, a, b in zip(("stressp", "stressm", "stress12"), got, ref):
        _close(a, b, 1e-12, name)
    assert float(np.abs(np.asarray(ref[0])).max()) > 1e3
    jf = jeap.calc_ffrac(*ref, J(d["a11"]), J(d["a12"]))
    tf = teap.calc_ffrac(*got, T(d["a11"]), T(d["a12"]))
    for name, a, b in zip(("m1", "m2"), tf, jf):
        _close(a, b, 1e-12, name)
    assert float(np.abs(np.asarray(jf[0])).max()) > 0.0   # fracturing acts


def _eap_both(dtype):
    jg, tg, cfg, f = _problem(dtype, over={"dynamics.ndte": NDTE,
                                           "dynamics.kdyn": 2})
    jp, _ = _preps(jg, tg, cfg, f)
    tp = convert.dynprep_from_numpy(_np(jp), "cpu")
    p = jcommon.evp_params(cfg.dynamics, 3600.0)
    strength = (2.75e4 * f["vice"] * np.exp(-20.0 * (1.0 - f["aice"]))
                ).astype(dtype)
    rng = np.random.default_rng(23)
    shape = (4,) + f["aice"].shape
    a11 = (0.5 + 0.4 * rng.random(shape)).astype(dtype)
    a12 = (0.1 * rng.standard_normal(shape)).astype(dtype)
    sp, sm, s12 = f["stress"]
    uo, vo = f["uocn"], f["vocn"]
    run = lambda s: jeap.eap_solve(  # noqa: E731
        jg, p, jp, s, jnp.asarray(sp), jnp.asarray(sm), jnp.asarray(s12),
        uocn=jnp.asarray(uo), vocn=jnp.asarray(vo), a11=jnp.asarray(a11),
        a12=jnp.asarray(a12))
    with jax.disable_jit():
        ref = run(jnp.asarray(strength))
    T = torch.as_tensor
    got = teap.eap_solve(tg, tcommon.evp_params(cfg.dynamics, 3600.0), tp,
                         T(strength), T(sp), T(sm), T(s12), uocn=T(uo),
                         vocn=T(vo), a11=T(a11), a12=T(a12))
    return got, ref


NAMES = ("uvel", "vvel", "stressp", "stressm", "stress12", "strintx",
         "strinty", "taubx", "tauby", "a11", "a12")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_eap_solve_matches_jax(dtype):
    got, ref = _eap_both(dtype)
    rtol = {"float64": 1e-8, "float32": 2e-3}[dtype]
    assert got[0].dtype == getattr(torch, dtype)
    assert float(np.abs(np.asarray(ref[0])).max()) > 1e-3    # ice moves
    assert float(np.abs(np.asarray(ref[-2])).max()) > 0.0     # a12 moves
    for name, a, b in zip(NAMES, got, ref):
        _close(a, b, rtol, name)
    assert set(got[-1]) == set(ref[-1])
    for k in ref[-1]:
        _close(got[-1][k], ref[-1][k], rtol, k)
