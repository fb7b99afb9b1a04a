"""PyTorch port vs JAX package: C- and CD-grid EVP dynamics
(cice_tpu_torch.dynamics.evp_c) and the C-grid dispatch of
`step_dyn_horiz`, alone and as two whole `Model.step`s of the `gridc` option
set on the 48x40 displaced-pole POP grid.

Inputs are made with numpy from a seed on a stretched rectangular grid
(every metric differs from its neighbours, so a shift of the wrong
metric shows). Tolerances: f64 at rtol 1e-8 of each field's largest
value (single stages repeat the JAX expressions term by term; the
40-subcycle solves add only reduction-order rounding); f32 at the JAX
package's engine-vs-engine 2e-3 of each field's largest value.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.config import Config  # noqa: E402
from cice_tpu.core.grid import rectgrid as jrectgrid  # noqa: E402
from cice_tpu.core.halo import BC as JBC  # noqa: E402
from cice_tpu.dynamics import common as jcommon  # noqa: E402
from cice_tpu.dynamics import evp_c as jevc  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.core.halo import BC as TBC  # noqa: E402
from cice_tpu_torch.dynamics import common as tcommon  # noqa: E402
from cice_tpu_torch.dynamics import evp_c as tevc  # noqa: E402
from cice_tpu_torch.model import driver as tdriver  # noqa: E402
from cice_tpu_torch.model.step import check_ported  # noqa: E402

from test_torch_evp import _np  # noqa: E402

NX, NY, NDTE = 40, 32, 40
RTOL = {"float64": 1e-8, "float32": 2e-3}


def _problem(dtype, ew="cyclic", over=None):
    """(jax grid, torch grid, cfg, fields): a stretched rectangular grid
    with land, ice thinning toward the middle, seeded face velocities and
    stresses."""
    jdt = jnp.dtype(dtype)
    cfg = Config().with_overrides(**{
        "grid.nx_global": NX, "grid.ny_global": NY,
        "grid.ew_boundary_type": ew, "dynamics.ndte": NDTE,
        "dynamics.coriolis": "latitude", **(over or {})})
    jg = jrectgrid(NX, NY, kmt_type="default", dtype=jdt,
                   bc=JBC(ew=ew, ns="open"), dxscale=1.02, dyscale=1.03)
    rng = np.random.default_rng(7)
    # water shallow enough (k1 = 0.0075) for the seabed stress to act
    jg = dataclasses.replace(jg, bathymetry=jnp.asarray(
        0.002 + 0.01 * rng.random((NY, NX)), jdt))
    tg = convert.grid_from_numpy(_np(jg), TBC(ew, "open"), "cpu")
    jj, ii = np.mgrid[0:NY, 0:NX]
    tm = np.asarray(jg.hm)
    aice = (0.95 - 0.3 * np.exp(-((ii - NX / 2) / 6.0) ** 2)) * tm
    f = dict(
        aice=aice,
        vice=aice * (1.0 + 0.5 * rng.random((NY, NX))),
        vsno=aice * 0.1 * rng.random((NY, NX)),
        uvelE=0.05 * rng.standard_normal((NY, NX)),
        vvelN=0.05 * rng.standard_normal((NY, NX)),
        vvelE=0.05 * rng.standard_normal((NY, NX)),
        uvelN=0.05 * rng.standard_normal((NY, NX)),
        strairx=0.12 * np.sin(2 * np.pi * jj / NY) + 0.06,
        strairy=0.08 * np.cos(2 * np.pi * ii / NX),
        uocn=0.1 * np.cos(2 * np.pi * jj / NY),
        vocn=0.05 * np.sin(2 * np.pi * ii / NX),
        stress=1e3 * rng.standard_normal((6, NY, NX)))
    f = {k: v.astype(dtype) for k, v in f.items()}
    return jg, tg, cfg, f


def _close(got, ref, rtol, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    if ref.dtype == np.bool_:
        np.testing.assert_array_equal(got, ref, err_msg=name)
        return
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


def _preps(jg, tg, cfg, f, dt=3600.0):
    kw = lambda A: dict(aice=A(f["aice"]), vice=A(f["vice"]),
                        vsno=A(f["vsno"]), uvelE=A(f["uvelE"]),
                        vvelN=A(f["vvelN"]), strairxT=A(f["strairx"]),
                        strairyT=A(f["strairy"]), uocn_T=A(f["uocn"]),
                        vocn_T=A(f["vocn"]))
    jp = jevc.dyn_prep_c(jg, cfg.dynamics, dt, **kw(jnp.asarray))
    tp = tevc.dyn_prep_c(tg, cfg.dynamics, dt, **kw(torch.as_tensor))
    kx = lambda A: dict(vvelE=A(f["vvelE"]), uvelN=A(f["uvelN"]),
                        strairxT=A(f["strairx"]), strairyT=A(f["strairy"]))
    jx = jevc.dyn_prep_cd(jg, cfg.dynamics, dt, jp, **kx(jnp.asarray))
    tx = tevc.dyn_prep_cd(tg, cfg.dynamics, dt, tp, **kx(torch.as_tensor))
    return jp, tp, jx, tx


def _strength(f):
    return 2.75e4 * f["vice"] * np.exp(-20.0 * (1.0 - f["aice"]))


@pytest.mark.parametrize("ew,over", [
    ("cyclic", {}),
    ("closed", {"dynamics.seabed_stress": True, "dynamics.threshold_hw": 5e3,
                "dynamics.coriolis": "constant", "dynamics.revised_evp": True})])
def test_prep_stages_and_finish_f64(ew, over):
    """dyn_prep_c, dyn_prep_cd, both strain rates, the stress divergence,
    deformations_C, the face seabed stress and c_dyn_finish."""
    jg, tg, cfg, f = _problem("float64", ew, over)
    jp, tp, jx, tx = _preps(jg, tg, cfg, f)
    for name, a, b in zip(tp._fields, tp, jp):
        _close(a, b, 1e-12, name)
    for name, a, b in zip(tx._fields, tx, jx):
        _close(a, b, 1e-12, name)
    if over:
        assert float(np.abs(np.asarray(jp.TbE)).max()) > 0.0

    J, T = jnp.asarray, torch.as_tensor
    uE, vN, vE, uN = f["uvelE"], f["vvelN"], f["vvelE"], f["uvelN"]
    uU, vU = 0.5 * (uE + vN), 0.5 * (vN - uE)
    for name, a, b in zip(("divU", "tensionU", "shearU"),
                          tevc.strain_rates_U_c(tg, *map(T, (uE, vE, uN, vN,
                                                              uU, vU))),
                          jevc.strain_rates_U_c(jg, *map(J, (uE, vE, uN, vN,
                                                              uU, vU)))):
        _close(a, b, 1e-12, name)
    for name, a, b in zip(("divT", "tensionT"),
                          tevc.strain_rates_T_c(tg, T(uE), T(vN)),
                          jevc.strain_rates_T_c(jg, J(uE), J(vN))):
        _close(a, b, 1e-12, name)
    sp, sm, s12 = f["stress"][:3]
    for name, a, b in zip(("strintxE", "strintyN"),
                          tevc.c_stress_divergence(tg, T(sp), T(sm), T(s12)),
                          jevc.c_stress_divergence(jg, J(sp), J(sm),
                                                   J(s12))):
        _close(a, b, 1e-12, name)
    p = jcommon.evp_params(cfg.dynamics, 3600.0)
    pt = tcommon.evp_params(cfg.dynamics, 3600.0)
    for name, a, b in zip(("divu", "shear", "Delta"),
                          tevc.deformations_C(tg, T(uE), T(vN), pt),
                          jevc.deformations_C(jg, J(uE), J(vN), p)):
        _close(a, b, 1e-12, name)
    for extra in (False, True):
        kw = lambda A: dict(vvelE=A(vE), uvelN=A(uN)) if extra else {}
        jo = jevc.c_dyn_finish(jg, jp, J(uE), J(vN), J(sp), J(sm), J(s12),
                               **kw(J))
        to = tevc.c_dyn_finish(tg, tp, T(uE), T(vN), T(sp), T(sm), T(s12),
                               **kw(T))
        assert set(to) == set(jo)
        for k in jo:
            _close(to[k], jo[k], 1e-12, k)


def _c_solve(dtype, over=None):
    jg, tg, cfg, f = _problem(dtype, over=over)
    jp, _, _, _ = _preps(jg, tg, cfg, f)
    tp = tevc.CPrep(*(torch.as_tensor(np.array(x)) for x in jp))
    p = jcommon.evp_params(cfg.dynamics, 3600.0)
    st = _strength(f)
    sp, sm, s12 = f["stress"][:3]
    ref = jax.jit(lambda: jevc.evp_c_solve(
        jg, p, jp, jnp.asarray(st), jnp.asarray(sp), jnp.asarray(sm),
        jnp.asarray(s12)))()
    T = torch.as_tensor
    got = tevc.evp_c_solve(tg, tcommon.evp_params(cfg.dynamics, 3600.0), tp,
                           T(st), T(sp), T(sm), T(s12))
    return got, ref


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_evp_c_solve(dtype):
    (fin, uU, vU), (jfin, juU, jvU) = _c_solve(dtype)
    assert fin.uvelE.dtype == getattr(torch, dtype)
    assert float(np.abs(np.asarray(jfin.uvelE)).max()) > 1e-3   # ice moves
    for name, a, b in zip(fin._fields + ("uvelU", "vvelU"),
                          tuple(fin) + (uU, vU), tuple(jfin) + (juU, jvU)):
        _close(a, b, RTOL[dtype], name)


def test_evp_c_solve_revised_seabed_f64():
    (fin, uU, vU), (jfin, juU, jvU) = _c_solve(
        "float64", {"dynamics.revised_evp": True,
                    "dynamics.seabed_stress": True,
                    "dynamics.threshold_hw": 5e3})
    for name, a, b in zip(fin._fields, fin, jfin):
        _close(a, b, 1e-8, name)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_evp_cd_solve(dtype):
    jg, tg, cfg, f = _problem(dtype)
    jp, _, jx, _ = _preps(jg, tg, cfg, f)
    T = torch.as_tensor
    tp = tevc.CPrep(*(T(np.array(x)) for x in jp))
    tx = tevc.CDPrepExtra(*(T(np.array(x)) for x in jx))
    p = jcommon.evp_params(cfg.dynamics, 3600.0)
    st = _strength(f)
    s = f["stress"]
    m = np.asarray(jp.iceTmask)
    init = lambda A, P, X: dict(
        uvelE=P.uvelE_init, vvelE=X.vvelE_init, uvelN=X.uvelN_init,
        vvelN=P.vvelN_init, stresspT=A(np.where(m, s[0], 0.0)),
        stressmT=A(np.where(m, s[1], 0.0)),
        stress12T=A(np.where(m, s[2], 0.0)), stresspU=A(s[3]),
        stressmU=A(s[4]), stress12U=A(s[5]))
    ref = jax.jit(lambda: jevc.evp_cd_solve(
        jg, p, jp, jx, jnp.asarray(st),
        jevc.CDEvpState(**init(jnp.asarray, jp, jx))))()
    got = tevc.evp_cd_solve(tg, tcommon.evp_params(cfg.dynamics, 3600.0),
                            tp, tx, T(st),
                            tevc.CDEvpState(**init(T, tp, tx)))
    (fin, uU, vU), (jfin, juU, jvU) = got, ref
    assert float(np.abs(np.asarray(jfin.vvelE)).max()) > 1e-3
    for name, a, b in zip(fin._fields + ("uvelU", "vvelU"),
                          tuple(fin) + (uU, vU), tuple(jfin) + (juU, jvU)):
        _close(a, b, RTOL[dtype], name)
    # the cross planes the port exports besides the JAX package's
    cross = tevc.cd_cross_planes(tg, tp, fin)
    assert all(bool(torch.isfinite(v).all()) for v in cross.values())
    assert float(cross["strintyE"].abs().max()) > 0.0


@pytest.mark.parametrize("grid_ice,kdyn", [("C", 2), ("CD", 3)])
def test_eap_and_vp_on_a_c_grid_are_refused(grid_ice, kdyn):
    """The JAX package runs the B-grid EAP and VP solvers on a C grid while
    its C-grid transport moves the ice with face velocities nothing then
    updates; the port refuses the combination."""
    cfg = Config().with_overrides(**{"grid.grid_ice": grid_ice,
                                     "dynamics.kdyn": kdyn})
    from cice_tpu_torch.config import Config as TConfig
    tcfg = TConfig().with_overrides(**{"grid.grid_ice": grid_ice,
                                       "dynamics.kdyn": kdyn})
    with pytest.raises(ValueError, match=f"kdyn={kdyn}"):
        check_ported(tcfg)
    assert cfg.grid.grid_ice == grid_ice     # the JAX package accepts it


# ---------------------------------------------------------------------------
# two whole coupled steps of the gridc option set against the JAX package
# ---------------------------------------------------------------------------

#: the port's C-grid diagnostics that the JAX package's step drops (its
#: history then writes zeros for them): the native E/N planes of
#: c_dyn_finish, held against the JAX function in the tests above
PORT_ONLY = {f"ncat_fluxes.{k}" for k in tevc.EN_PLANES} | {
    f"ncat_fluxes.{k}" for k in ("strintyE", "strintxN", "taubyE",
                                 "taubxN")}


def _without(tree, keys):
    return {k: v for k, v in tree.items() if k not in keys}


def _jax_steps(jcfg, steps, pert=0.0):
    """[(state, flux)] of `steps` jitted JAX model_steps from the initial
    state with vicen x (1 + pert), on the forcing Model.step sees."""
    from cice_tpu import constants as jcst
    from cice_tpu.model.driver import Model as JModel
    from cice_tpu.model.forcing import get_forcing as jget_forcing
    from cice_tpu.model.step import model_step as jmodel_step
    jm = JModel(jcfg)
    dt = jcfg.setup.dt
    fn = jax.jit(lambda s, fc: jmodel_step(jm.static, jm.grid, s, fc, dt))
    st, fc, out = jm.state, jm.forcing, []
    st = st.replace(vicen=st.vicen * (1.0 + pert))
    for step in range(steps):
        t = step * dt
        fc = jget_forcing(jcfg, jm.grid, t, 1.0 + t / jcst.secday, st.aice,
                          fc)
        st, fl = fn(st, fc)
        out.append((convert.tree_to_numpy(st), convert.tree_to_numpy(fl)))
    return out


def steps_against_jax(tcfg, jcfg, dtype, steps=2, envelope=False,
                      floors=None, min_speed=1e-3):
    """`steps` Model.steps of tcfg against the JAX model_step of jcfg,
    leaf by leaf with tests/test_torch_step.py's tolerances and floors
    (and `floors`, {leaf: absolute floor}). With `envelope`, a leaf may
    also differ by up to 50 times the JAX package's own envelope: how far
    its result moves when vicen moves by 1e-15 (f64) or 2e-7 (f32). One
    perturbation samples that envelope, and over several steps it grows by
    orders of magnitude, so the bar is the one
    tests/test_torch_baseline_sensitivity.py holds (a ratio under 50)."""
    import test_torch_step as ts
    ref = _jax_steps(jcfg, steps)
    env = _jax_steps(jcfg, steps, 1e-15 if dtype == "float64" else 2e-7) \
        if envelope else None
    m = tdriver.Model(tcfg, device="cpu")
    f32 = dtype == "float32"
    for step in range(steps):
        m.step()
        got = (convert.state_to_numpy(m.state), _without(
            convert.tree_to_numpy(convert.fluxout_to_numpy(m.flux)),
            PORT_ONLY))
        for part, (g, r) in enumerate(zip(got, ref[step])):
            what = f"{dtype} step {step + 1} {('state', 'flux')[part]}"
            g = ts._tree(g)
            extra = {"transport_checks.neg_mass_depth"}
            assert set(r) <= set(g) and set(g) - set(r) <= extra, \
                (what, set(g) ^ set(r))
            for k in r:
                leaf = k.split(".")[-1]
                a, b = np.asarray(g[k]), np.asarray(r[k])
                assert a.shape == b.shape, (what, k)
                if b.dtype == np.bool_:
                    np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")
                    continue
                if leaf in ts.CHECK_BOUNDS:
                    bound = ts.CHECK_BOUNDS[leaf][f32]
                    assert float(a) < bound and float(b) < bound, (what, k)
                    continue
                atol = max(ts.RTOL[dtype] * float(np.abs(b).max()),
                           ts.FLOORS.get(leaf, (0, 0))[f32],
                           (floors or {}).get(leaf, 0.0))
                if env is not None:
                    e = np.asarray(env[step][part][k])
                    atol = max(atol, 50.0 * float(np.abs(e - b).max()))
                np.testing.assert_allclose(a, b, rtol=ts.RTOL[dtype],
                                           atol=atol, err_msg=f"{what}: {k}")
    assert float(np.abs(ref[-1][0]["uvel"]).max()) > min_speed
    return m, ref


def two_steps_against_jax(dtype, over, **kw):
    """Two `Model.step`s of the gx1pop_step configuration (48x40) with
    `over` in both packages (steps_against_jax)."""
    import test_torch_step as ts
    tcfg, jcfg = ts._cfgs(dtype, **over)
    return steps_against_jax(tcfg, jcfg, dtype, **kw)


GRIDC = {"grid.grid_ice": "C"}


def test_two_gridc_steps_match_jax_f64():
    m, ref = two_steps_against_jax("float64", GRIDC)
    assert float(np.abs(ref[-1][0]["uvelE"]).max()) > 1e-3
    # the native planes are there and finite
    for k in tevc.EN_PLANES:
        assert bool(torch.isfinite(m.flux.ncat_fluxes[k]).all()), k


@pytest.mark.slow
@pytest.mark.parametrize("dtype,over", [
    ("float32", GRIDC), ("float64", {"grid.grid_ice": "CD"})],
    ids=["gridc_f32", "gridcd_f64"])
def test_two_c_grid_steps_match_jax_slow(dtype, over):
    two_steps_against_jax(dtype, over)


@pytest.mark.parametrize("over", [GRIDC, {"dynamics.kdyn": 2}],
                         ids=["gridc", "eap"])
def test_continue_from_a_restart_is_bit_for_bit(tmp_path, over):
    """A run continued from a restart equals the uninterrupted run bit for
    bit: the face velocities and the slot-0 stresses (gridc) and the
    structure tensor a11/a12 (eap) ride in the restart's state planes."""
    import os
    import shutil
    from cice_tpu_torch import config as tconfig
    from cice_tpu_torch.model.state import state_leaves
    restart = os.path.join(str(tmp_path), "restart")
    cfg = tconfig.gx1pop_step(48, 40).with_overrides(**{
        "dynamics.ndte": 10, "dtype": "float64", "setup.dumpfreq": "1",
        "setup.dumpfreq_n": 2, "setup.restart_dir": restart,
        "setup.pointer_file": os.path.join(restart, "ice.restart_file"),
        **over})
    a = tdriver.Model(cfg, device="cpu")
    a.run(2)
    ptr = shutil.copy(cfg.setup.pointer_file,
                      os.path.join(str(tmp_path), "pointer"))
    a.run(2)
    b = tdriver.Model(cfg.with_overrides(**{
        "setup.runtype": "continue", "setup.pointer_file": ptr}),
        device="cpu")
    assert b.istep == 2
    b.run(2)
    for x, y in zip(state_leaves(a.state), state_leaves(b.state)):
        assert torch.equal(x, y)
    if over is GRIDC:
        assert float(a.state.uvelE.abs().max()) > 1e-3
        assert float(a.state.stress12[0].abs().max()) > 0.0
    else:
        assert float((a.state.a11 - 0.5).abs().max()) > 0.0
