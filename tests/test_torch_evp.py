"""PyTorch port vs JAX package: B-grid EVP dynamics (cice_tpu_torch.
dynamics.common / .dynamics.evp) and the fused EVP kernel's wrapper
(cice_tpu_torch.kernels.evp), whose CPU path is the plain `evp_solve`.

Tolerances: in f64 the port repeats the JAX expressions term by term, so
single stages agree to 1e-10 relative and the 40-subcycle solve to 1e-9
(only reduction order differs). In f32 the bar is the JAX package's own
engine-vs-engine gate (tests/test_evp_pallas.py:55): max velocity error
below 2e-4 of the largest velocity.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.config import Config  # noqa: E402
from cice_tpu.core.grid import rectgrid as jrectgrid  # noqa: E402
from cice_tpu.core.halo import BC as JBC  # noqa: E402
from cice_tpu.dynamics import common as jcommon  # noqa: E402
from cice_tpu.dynamics import evp as jevp  # noqa: E402
from cice_tpu.kernels.evp_pallas import evp_solve_fused as jfused  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.core.halo import BC as TBC  # noqa: E402
from cice_tpu_torch.dynamics import common as tcommon  # noqa: E402
from cice_tpu_torch.dynamics import evp as tevp  # noqa: E402
from cice_tpu_torch.kernels import evp as tkevp  # noqa: E402

NX, NY, NDTE = 64, 48, 40


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if f.name not in ("bc", "nx_global", "ny_global")}


def _problem(dtype, ew="cyclic", over=None):
    """EVP inputs made with numpy from a seed (as tests/test_evp_pallas.py
    builds them), in both packages: (jax grid, torch grid, cfg, fields)."""
    jdt = jnp.dtype(dtype)
    cfg = Config().with_overrides(**{
        "grid.nx_global": NX, "grid.ny_global": NY,
        "grid.ew_boundary_type": ew, "dynamics.ndte": NDTE,
        "dynamics.coriolis": "latitude", **(over or {})})
    jg = jrectgrid(NX, NY, kmt_type="default", dtype=jdt,
                   bc=JBC(ew=ew, ns="open"))
    tg = convert.grid_from_numpy(_np(jg), TBC(ew, "open"), "cpu")
    rng = np.random.default_rng(42)
    jj, ii = np.mgrid[0:NY, 0:NX]
    tm = np.asarray(jg.hm)
    aice = (0.9 - 0.2 * np.exp(-((ii - NX / 2) / 8.0) ** 2)) * tm
    f = dict(
        aice=aice,
        vice=aice * (1.0 + 0.4 * rng.random((NY, NX))),
        vsno=aice * 0.1 * rng.random((NY, NX)),
        uvel=0.05 * rng.standard_normal((NY, NX)),
        vvel=0.05 * rng.standard_normal((NY, NX)),
        strairx=0.12 * np.sin(2 * np.pi * jj / NY) + 0.06,
        strairy=0.08 * np.cos(2 * np.pi * ii / NX),
        uocn=0.1 * np.cos(2 * np.pi * jj / NY),
        vocn=0.05 * np.sin(2 * np.pi * ii / NX),
        stress=1e3 * rng.standard_normal((3, 4, NY, NX)),
        prev_mask=rng.random((NY, NX)) > 0.3)
    f = {k: (v if v.dtype == np.bool_ else v.astype(dtype))
         for k, v in f.items()}
    return jg, tg, cfg, f


def _preps(jg, tg, cfg, f, dt=3600.0):
    kw = lambda A, B: dict(
        aice=A(f["aice"]), vice=A(f["vice"]), vsno=A(f["vsno"]),
        aiceU_prev_mask=B(f["prev_mask"]), uvel=A(f["uvel"]),
        vvel=A(f["vvel"]), strairxT=A(f["strairx"]),
        strairyT=A(f["strairy"]), uocn_T=A(f["uocn"]),
        vocn_T=A(f["vocn"]), ss_tltx_T=A(0 * f["uocn"]),
        ss_tlty_T=A(0 * f["uocn"]))
    jp = jcommon.dyn_prep(jg, cfg.dynamics, dt, **kw(jnp.asarray,
                                                     jnp.asarray))
    tp = tcommon.dyn_prep(tg, cfg.dynamics, dt, **kw(torch.as_tensor,
                                                     torch.as_tensor))
    return jp, tp


def _close(got, ref, rtol, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    if ref.dtype == np.bool_:
        np.testing.assert_array_equal(got, ref, err_msg=name)
        return
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


@pytest.mark.parametrize("ew,over", [
    ("cyclic", {}),
    ("closed", {"dynamics.seabed_stress": True, "dynamics.threshold_hw": 5e3,
                "dynamics.capping_method": "sum", "dynamics.Ktens": 0.1,
                "dynamics.ssh_stress": "coupled"})])
def test_dyn_prep_strain_stress_stepu_f64(ew, over):
    jg, tg, cfg, f = _problem("float64", ew, over)
    jp, tp = _preps(jg, tg, cfg, f)
    for k in tcommon.DYNPREP_FIELDS:
        _close(getattr(tp, k), getattr(jp, k), 1e-10, k)

    p = jcommon.evp_params(cfg.dynamics, 3600.0)
    pt = tcommon.evp_params(cfg.dynamics, 3600.0)
    assert tuple(pt) == tuple(p)
    u, v = f["uvel"], f["vvel"]
    jsr = jcommon.strain_rates_B(jg, jnp.asarray(u), jnp.asarray(v), p)
    tsr = tcommon.strain_rates_B(tg, torch.as_tensor(u), torch.as_tensor(v),
                                 pt)
    for name, a, b in zip(tsr._fields, tsr, jsr):
        _close(a, b, 1e-10, name)

    strength = (2.75e4 * f["vice"] * np.exp(-20.0 * (1.0 - f["aice"])))
    dmin = p.deltaminEVP * np.asarray(jg.tarea)
    sp, sm, s12 = f["stress"]
    jout = jevp.stress_update(jg, p, jnp.asarray(strength), jnp.asarray(dmin),
                              jnp.asarray(u), jnp.asarray(v),
                              jnp.asarray(sp), jnp.asarray(sm),
                              jnp.asarray(s12), jp.iceTmask)
    T = torch.as_tensor
    tout = tevp.stress_update(tg, pt, T(strength), T(dmin), T(u), T(v),
                              T(sp), T(sm), T(s12), tp.iceTmask)
    for name, a, b in zip(("sp", "sm", "s12", "strintx", "strinty"),
                          tout, jout):
        _close(a, b, 1e-10, name)

    jsu = jcommon.stepu_dense(jnp.asarray(u), jnp.asarray(v), jout[3],
                              jout[4], jp, p, jnp.asarray(f["uocn"]),
                              jnp.asarray(f["vocn"]))
    tsu = tcommon.stepu_dense(T(u), T(v), tout[3], tout[4], tp, pt,
                              T(f["uocn"]), T(f["vocn"]))
    for name, a, b in zip(("u", "v", "taubx", "tauby"), tsu, jsu):
        _close(a, b, 1e-10, name)


def _solve_both(dtype, solver_t, solver_j):
    jg, tg, cfg, f = _problem(dtype)
    jp, _ = _preps(jg, tg, cfg, f)
    tp = convert.dynprep_from_numpy(_np(jp), "cpu")
    p = jcommon.evp_params(cfg.dynamics, 3600.0)
    strength = (2.75e4 * f["vice"] * np.exp(-20.0 * (1.0 - f["aice"]))
                ).astype(dtype)
    uo, vo = f["uocn"], f["vocn"]
    sp, sm, s12 = f["stress"]
    ref = jax.jit(lambda: solver_j(jg, p, jp, jnp.asarray(strength),
                                   jnp.asarray(sp), jnp.asarray(sm),
                                   jnp.asarray(s12), uocn=jnp.asarray(uo),
                                   vocn=jnp.asarray(vo)))()
    T = torch.as_tensor
    got = solver_t(tg, tcommon.evp_params(cfg.dynamics, 3600.0), tp,
                   T(strength), T(sp), T(sm), T(s12), uocn=T(uo),
                   vocn=T(vo))
    return got, ref


def _uv_err(got, ref):
    u0, v0 = np.asarray(ref[0]), np.asarray(ref[1])
    scale = float(np.max(np.sqrt(u0 ** 2 + v0 ** 2)))
    err = float(np.max(np.sqrt((got[0].numpy() - u0) ** 2 +
                               (got[1].numpy() - v0) ** 2)))
    assert scale > 1e-3          # the flow is nontrivial
    return err / scale


def test_evp_solve_f64():
    got, ref = _solve_both("float64", tevp.evp_solve, jevp.evp_solve)
    names = ("uvel", "vvel", "stressp", "stressm", "stress12", "strintx",
             "strinty", "taubx", "tauby")
    for name, a, b in zip(names, got, ref):
        _close(a, b, 1e-9, name)


def test_evp_solve_f32():
    got, ref = _solve_both("float32", tevp.evp_solve, jevp.evp_solve)
    assert got[0].dtype == torch.float32
    assert _uv_err(got, ref) < 2e-4


def test_fused_wrapper_cpu_matches_jax_pallas_interpret():
    """The K1 wrapper on CPU tensors (its plain version) against the JAX
    Pallas kernel run by the interpreter."""
    before = tkevp.launches
    got, ref = _solve_both(
        "float32", tkevp.evp_solve_fused,
        lambda *a, **k: jfused(*a, **k, k_fuse=8, interpret=True))
    assert np.isfinite(got[0].numpy()).all()
    assert _uv_err(got, ref) < 2e-4
    assert tkevp.launches == before     # CPU tensors never reach the kernel


@pytest.mark.parametrize("case", ["tripole", "y_cyclic", "float64"])
def test_fused_wrapper_on_cuda_raises_where_the_kernel_cannot_go(
        monkeypatch, case):
    """On a CUDA device evp_solve_fused launches K1 or raises; it never
    runs the plain loop there (the JAX package falls back to its XLA loop
    on a tripole or y-cyclic grid and solves f64 in f32). The device check
    is patched, so no card is needed; the raise comes before anything is
    built."""
    monkeypatch.setattr(tkevp, "_on_cuda", lambda t: True)
    dtype = "float64" if case == "float64" else "float32"
    jg, tg, cfg, f = _problem(dtype)
    ns = {"tripole": "tripole", "y_cyclic": "cyclic"}.get(case, "open")
    tg = dataclasses.replace(tg, bc=TBC("cyclic", ns))
    _, tp = _preps(jg, tg, cfg, f)
    T = torch.as_tensor
    sp, sm, s12 = f["stress"]
    exc, what = ((ValueError, "f32-only") if case == "float64" else
                 (NotImplementedError, "ROADMAP A9"))
    before = tkevp.launches
    with pytest.raises(exc, match=what):
        tkevp.evp_solve_fused(tg, tcommon.evp_params(cfg.dynamics, 3600.0),
                              tp, T(f["vice"]), T(sp), T(sm), T(s12),
                              uocn=T(f["uocn"]), vocn=T(f["vocn"]))
    assert tkevp.launches == before


def test_kernel_params_follow_evp_params():
    p = tcommon.evp_params(Config().dynamics, 3600.0)
    vals = list(tkevp.kernel_params(p))
    assert vals[0] == np.float32(p.e_factor)
    assert vals[5] == np.float32(1.0 - p.arlx1i * p.revp)
    assert vals[8] == np.float32(p.brlx + p.revp)
    assert len(tkevp.CONST_PLANES) == 26
