"""PyTorch port vs JAX package: the z tracers on the brine column
(cice_tpu_torch/columns/zbgc_vertical.py against
cice_tpu/columns/zbgc_vertical.py) on the same numpy inputs made from a
seed (ncat=5, 12x10 cells, CPU): the tracer inventory and mobility types,
the porosity and PAR profiles, the tridiagonal solve (the port's stacked
right-hand sides against the JAX package's one solve per system), the
reaction network, and `step_zbgc` as a whole: the port stacks every z
tracer on one leading dimension where the JAX package loops over names.

The configuration is the `bgcz` option set's network with the z aerosols,
humics and the second iron classes added, so every tracer family and
mobility type takes part (22 tracers).

The JAX reference runs op by op (jax.disable_jit): jitted XLA contracts
float32 a*b+c into fused multiply-adds.

Tolerances: f64, 1e-12 of each field's largest value (the same elementwise
arithmetic in the same order; the porosity interpolation's matmul and the
reductions over categories and layers sum in another order, ~1e-16);
f32, 1e-4 of each field's largest value: the mushy temperature inversion
under the porosity cancels near the liquidus (tests/test_mushy.py:33
holds it to 1e-3 C), and the inversion's few-ulp differences pass through
exp() of the Thomas solve's diagonal.
"""

import os
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.columns import mushy as jmushy  # noqa: E402
from cice_tpu.columns import zbgc_vertical as jz  # noqa: E402
from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu_torch.columns import zbgc_vertical as tz  # noqa: E402
from cice_tpu_torch.config import Config as TConfig  # noqa: E402

NCAT, NILYR, NY, NX = 5, 7, 10, 12
DT = 3600.0
RTOL = {"float64": 1e-12, "float32": 1e-4}
BGCZ = {"zbgc.z_tracers": True, "zbgc.solve_zbgc": True,
        "tracers.tr_brine": True, "zbgc.tr_bgc_Am": True,
        "zbgc.tr_bgc_Sil": True, "zbgc.tr_bgc_DMS": True,
        "zbgc.tr_bgc_PON": True, "zbgc.tr_bgc_DON": True,
        "zbgc.tr_bgc_Fe": True, "zbgc.tr_bgc_C": True, "zbgc.n_doc": 2,
        "zbgc.n_dic": 1, "zbgc.n_algae": 3}
FULL = {**BGCZ, "zbgc.tr_zaero": True, "zbgc.n_zaero": 3,
        "zbgc.tr_bgc_hum": True, "zbgc.n_fed": 2, "zbgc.n_fep": 2}


def _zcfgs(**over):
    return (TConfig().with_overrides(**over).zbgc,
            JConfig().with_overrides(**over).zbgc)


def _close(got, ref, what, dtype):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    r = np.asarray(ref)
    assert g.shape == r.shape and g.dtype == r.dtype, (what, g.shape,
                                                       r.shape)
    scale = max(float(np.abs(r).max()), 1e-300)
    np.testing.assert_allclose(g, r, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * scale, err_msg=what)


def _close_dict(got, ref, what, dtype):
    assert list(got) == list(ref), (what, list(got), list(ref))
    for k in ref:
        _close(got[k], ref[k], f"{what}: {k}", dtype)


def _ice_column(rng, dtype, shp=(NCAT, NY, NX)):
    """Ice with some empty categories, bulk salinities and enthalpies of
    mush between -15 C and the liquidus (and some fully cold layers)."""
    aicen = np.where(rng.random(shp) < 0.2, 0.0, 0.05 + 0.3 * rng.random(shp))
    hin = 0.1 + 2.5 * rng.random(shp)
    lay = (NCAT, NILYR) + shp[1:]
    S = 0.5 + 12.0 * rng.random(lay)
    T = -15.0 * rng.random(lay) ** 2 - 0.05
    with jax.disable_jit():
        q = np.asarray(jmushy.enthalpy_mush(jnp.asarray(T), jnp.asarray(S)))
    return dict(aicen=aicen, vicen=aicen * hin,
                vsnon=aicen * np.where(rng.random(shp) < 0.3, 0.005,
                                       0.4 * rng.random(shp)),
                fbri=np.where(aicen > 0, 0.3 + 0.9 * rng.random(shp), 0.0),
                qice=q.astype(dtype), sice=S.astype(dtype))


def _step_inputs(rng, dtype, names, nb, with_snow=True, with_dep=True):
    shp = (NCAT, NY, NX)
    a = _ice_column(rng, dtype)
    a.update(
        darcy_V=1e-7 * (rng.random(shp) - 0.5),
        fswthru=np.where(rng.random(shp) < 0.2, 0.0, 60.0 * rng.random(shp)),
        Tbot=-1.8 + 0.2 * rng.random((NY, NX)),
        meltt=np.where(rng.random(shp) < 0.5, 0.0, 0.01 * rng.random(shp)),
        meltb=np.where(rng.random(shp) < 0.5, 0.0, 0.01 * rng.random(shp)),
        congel=np.where(rng.random(shp) < 0.5, 0.0, 0.01 * rng.random(shp)),
        frazil=np.where(rng.random((NY, NX)) < 0.7, 0.0,
                        0.02 * rng.random((NY, NX))),
        melts=np.where(rng.random(shp) < 0.5, 0.0, 0.02 * rng.random(shp)))
    lay = (NCAT, nb) + shp[1:]
    trc = {n: 20.0 * rng.random(lay) ** 2 for n in names}
    trc[names[0]][0, 0] = -1e-3              # negative input clamps at 0
    frac = {n: rng.random(lay) for n in names}
    snow = {n: 0.5 * rng.random(shp) for n in names} if with_snow else None
    dep = ({n: np.full((NY, NX), 1e-9 * (i + 1)) for i, n in
            enumerate(names) if n.startswith("zaero")} if with_dep else None)
    cast = lambda x: x.astype(dtype)
    a = {k: cast(v) for k, v in a.items()}
    trc = {k: cast(v) for k, v in trc.items()}
    frac = {k: cast(v) for k, v in frac.items()}
    snow = None if snow is None else {k: cast(v) for k, v in snow.items()}
    dep = None if dep is None else {k: cast(v) for k, v in dep.items()}
    return a, trc, frac, snow, dep


def _call(mod, arr, zcfg, a, trc, frac, snow, dep, ocean=None):
    conv = (lambda d: None if d is None else {k: arr(v)
                                              for k, v in d.items()})
    return mod.step_zbgc(zcfg, DT, **{k: arr(v) for k, v in a.items()},
                         trc=conv(trc), frac=conv(frac), snow=conv(snow),
                         zaero_dep=conv(dep), ocean=conv(ocean))


def test_tracer_inventory_mobility_and_ocean_defaults_equal_jax():
    for over in (BGCZ, FULL, {"zbgc.z_tracers": True, "zbgc.tr_zaero": True,
                              "zbgc.n_zaero": 6}):
        tzc, jzc = _zcfgs(**over)
        names = tz.z_tracer_names(tzc)
        assert names == jz.z_tracer_names(jzc)
        assert [tz.mobility_type(tzc, n) for n in names] == \
            [jz.mobility_type(jzc, n) for n in names]
        assert [tz.ocean_concentration(tzc, n) for n in names] == \
            [jz.ocean_concentration(jzc, n) for n in names]
    assert len(tz.z_tracer_names(_zcfgs(**FULL)[0])) == 22


@pytest.mark.parametrize("nb", [7, 4, 10])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_porosity_and_par_profiles_match_jax(dtype, nb):
    rng = np.random.default_rng(70)
    a = _ice_column(rng, dtype)
    hbr = (a["fbri"] * a["vicen"] / np.maximum(a["aicen"], 1e-11)).astype(
        dtype)
    fsw = (50.0 * rng.random((NCAT, NY, NX))).astype(dtype)
    chl = (0.2 * rng.random((NCAT, nb, NY, NX))).astype(dtype)
    tzc, jzc = _zcfgs(**BGCZ)
    with jax.disable_jit():
        rphi = jz.porosity_profile(jnp.asarray(a["qice"]),
                                   jnp.asarray(a["sice"]), nb)
        rpar = jz.par_profile(jnp.asarray(fsw), jnp.asarray(chl),
                              jnp.asarray(hbr), nb, jzc)
        rpar0 = jz.par_profile(jnp.asarray(fsw), 0.0, jnp.asarray(hbr), nb,
                               jzc)
    T = torch.as_tensor
    _close(tz.porosity_profile(T(a["qice"]), T(a["sice"]), nb),
           np.asarray(rphi).astype(dtype), f"porosity nb={nb}", dtype)
    _close(tz.par_profile(T(fsw), T(chl), T(hbr), nb, tzc), rpar,
           "PAR", dtype)
    _close(tz.par_profile(T(fsw), 0.0, T(hbr), nb, tzc), rpar0,
           "PAR, no chlorophyll", dtype)
    phi = np.asarray(rphi)
    assert phi.min() < 0.05 < phi.max()      # both sides of PHI_C


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_stacked_tridiag_solve_equals_one_solve_per_system(dtype):
    """Five right-hand sides share the coefficients in the port's stacked
    solve; the JAX package solves each alone, in its direct form, with the
    diagonal the port's columns imply (excess plus the couplings that
    leave the column). Where the couplings dwarf the excess the direct
    form's pivot cancels; the port's solve equals the exact solution."""
    rng = np.random.default_rng(71)
    shp = (NCAT, 7, NY, NX)
    lower = -rng.random(shp)
    upper = -rng.random(shp)
    lower[:, 0] = 0.0
    upper[:, -1] = 0.0
    excess = 0.05 + rng.random(shp)
    diag = excess.copy()
    diag[:, 1:] += np.abs(upper[:, :-1])
    diag[:, :-1] += np.abs(lower[:, 1:])
    rhs = rng.random((5,) + shp)
    c = lambda x: x.astype(dtype)
    with jax.disable_jit():
        ref = np.stack([np.asarray(jz.tridiag_solve(
            *(jnp.asarray(c(x)) for x in (lower, diag, upper, r))))
            for r in rhs])
    got = tz.tridiag_solve(*(torch.as_tensor(c(x)) for x in (lower, upper,
                                                            excess, rhs)))
    assert np.isfinite(ref).all()
    _close(got.numpy(), ref, "tridiag", dtype)
    single = tz.tridiag_solve(*(torch.as_tensor(c(x)) for x in (
        lower, upper, excess, rhs[2])))
    assert torch.equal(single, got[2]) or dtype == "float32"
    # a column whose couplings are 1e18 times its excess (a brine column
    # near zero height), where the direct form's pivot cancels (to zero,
    # and the 1e-30 guard, in float32): the solve keeps the exact solution
    lower[:, :, 0, 0] *= 1e18
    upper[:, :, 0, 0] *= 1e18
    sys_ = [c(x) for x in (lower, upper, excess, rhs)]
    got = tz.tridiag_solve(*(torch.as_tensor(x) for x in sys_)).numpy()
    for cat in range(NCAT):
        ex = _exact_solve(*sys_, cat, 0)
        err = np.abs(got[:, cat, :, 0, 0] - ex) / np.abs(ex)
        assert float(err.max()) <= C2_SOLVE[dtype], cat


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("over", [FULL, {**FULL, "zbgc.tr_bgc_Am": False,
                                         "zbgc.tr_bgc_DON": False}],
                         ids=["full", "no_ammonium"])
def test_algal_network_matches_jax(dtype, over):
    rng = np.random.default_rng(72)
    tzc, jzc = _zcfgs(**over)
    names = tz.z_tracer_names(tzc)
    lay = (NCAT, 7, NY, NX)
    trc = {n: (20.0 * rng.random(lay) ** 2).astype(dtype) for n in names}
    trc["bgc_Nit"][0, 0] = 0.0
    PAR = (40.0 * rng.random(lay)).astype(dtype)
    Tl = (-1.8 - 3.0 * rng.random(lay)).astype(dtype)
    with jax.disable_jit():
        r_out, r_grow, r_diag = jz.algal_network(
            jzc, DT, {k: jnp.asarray(v) for k, v in trc.items()},
            jnp.asarray(PAR), jnp.asarray(Tl))
    g_out, g_grow, g_diag = tz.algal_network(
        tzc, DT, {k: torch.as_tensor(v) for k, v in trc.items()},
        torch.as_tensor(PAR), torch.as_tensor(Tl))
    _close_dict(g_out, r_out, "network", dtype)
    _close(g_grow, r_grow, "grow_net", dtype)
    _close_dict(g_diag, r_diag, "uptake", dtype)
    assert float(np.asarray(r_diag["upNO"]).max()) > 0.0


def _step_pair(dtype, over=FULL, nb=7, ocean=None, **kw):
    rng = np.random.default_rng(73)
    tzc, jzc = _zcfgs(**over)
    names = tz.z_tracer_names(tzc)
    args = _step_inputs(rng, dtype, names, nb, **kw)
    with jax.disable_jit():
        ref = _call(jz, jnp.asarray, jzc, *args, ocean=ocean)
    got = _call(tz, torch.as_tensor, tzc, *args, ocean=ocean)
    return got, ref, names


def _close_out(got, ref, what, dtype):
    for part in ("trc", "frac", "flux_ocn", "diags", "snow"):
        _close_dict(getattr(got, part), getattr(ref, part),
                    f"{what} {part}", dtype)
    _close(got.grow_net, ref.grow_net, f"{what} grow_net", dtype)
    _close(got.chl_int, ref.chl_int, f"{what} chl_int", dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_stacked_step_zbgc_matches_the_jax_loop_over_names(dtype):
    """Snow reservoirs with z-aerosol deposition, mobile and stationary
    exchange of every mobility type, the stacked transport solve,
    entrainment, the reaction network and the history diagnostics."""
    got, ref, names = _step_pair(dtype)
    _close_out(got, ref, f"step_zbgc {dtype}", dtype)
    frac = np.stack([np.asarray(ref.frac[n]) for n in names])
    assert (frac == 1.0).any() and ((frac > 0) & (frac < 1)).any()
    assert float(np.abs(np.asarray(ref.flux_ocn["bgc_Nit"])).max()) > 0.0
    assert float(np.asarray(ref.snow["zaero1"]).max()) > 0.0


@pytest.mark.parametrize("case", ["no_snow", "ocean", "nblyr4",
                                  "no_reactions"])
def test_step_zbgc_variants_match_jax(case):
    """Without snow reservoirs (deposition straight into the top layer),
    with mixed-layer overrides for two tracers, on a bio grid of 4 layers
    under 7 ice layers, and with solve_zbgc off (z aerosols only)."""
    kw = {}
    over = FULL
    if case == "no_snow":
        kw = dict(with_snow=False)
    elif case == "ocean":
        kw = dict(ocean={"bgc_Nit": np.full((NCAT, NY, NX), 3.5),
                         "bgc_Sil": np.full((NCAT, NY, NX), 12.0)})
    elif case == "nblyr4":
        kw = dict(nb=4)
    else:
        over = {"zbgc.z_tracers": True, "zbgc.tr_bgc_N": False,
                "zbgc.tr_bgc_Nit": False, "zbgc.tr_zaero": True,
                "zbgc.n_zaero": 3, "tracers.tr_brine": True}
    got, ref, _ = _step_pair("float64", over=over, **kw)
    _close_out(got, ref, f"step_zbgc {case}", "float64")


def test_partial_snow_reservoirs_are_refused():
    tzc, _ = _zcfgs(**FULL)
    names = tz.z_tracer_names(tzc)
    a, trc, frac, snow, dep = _step_inputs(np.random.default_rng(74),
                                           "float64", names, 7)
    snow.pop(names[-1])
    with pytest.raises(ValueError, match="every z tracer or for none"):
        _call(tz, torch.as_tensor, tzc, a, trc, frac, snow, dep)


# ---------------------------------------------------------------------------
# the thin brine column of the gx1bgcz cell (ROADMAP C2)
# ---------------------------------------------------------------------------

#: step_zbgc's inputs at five columns of float32 gx1pop,evp1d,bgcz runs on
#: the card (320x384, seeded NCAR monthly forcing; `where`: seed, step,
#: j, i, latitude): c0, the thinnest brine column under ice of 13 runs of
#: 300 steps (seed 2721000203, step 171, 59.5S: category 1 melted
#: through in this step, vicen 0 at aicen 4.9e-3, so its bio layers sit
#: at dz = puny and the transport's couplings reach 1.8e20); c1-c4 the
#: thinnest of four other runs (brine 2.0-2.4 mm), sound columns.
C2 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                  "zbgc_c2_columns.npz")
#: float32 against the mended float64, of each field's largest: the
#: float32 step reads at most 1.1e-6 on these columns; their inputs
#: rounded to bfloat16 read 1.1e-3 and more
C2_F32 = 1e-5
#: the transport's tridiagonal solve against the exact (rational)
#: solution of the same system, elementwise: float32 reads 4.1e-7,
#: float64 5.2e-16 on c0
C2_SOLVE = {"float32": 1e-5, "float64": 1e-14}


def _c2_inputs(dtype, names, bf16=False):
    """The five columns stacked on the y axis: (ncat, 5, 1) planes."""
    f = np.load(C2)
    cols = [f"c{i}" for i in range(5)]

    def cast(x):
        t = torch.as_tensor(x)
        return (t.to(torch.bfloat16) if bf16 else t).to(getattr(torch,
                                                                 dtype))

    def get(k, axis):
        return cast(np.stack([f[f"{c}.{k}"] for c in cols], axis)[..., None])

    kw = {k: get(k, 1) for k in ("aicen", "vicen", "vsnon", "fbri",
                                 "darcy_V", "fswthru", "meltt", "meltb",
                                 "congel", "melts")}
    kw.update(qice=get("qice", 2), sice=get("sice", 2),
              Tbot=get("Tbot", 0), frazil=get("frazil", 0),
              trc={n: get(f"trc.{n}", 2) for n in names},
              frac={n: get(f"frac.{n}", 2) for n in names},
              snow={n: get(f"snow.{n}", 1) for n in names})
    return kw


def _exact_solve(lower, upper, excess, rhs, cat, col):
    """The exact solution (in rationals, rounded at the end) of one
    category's system at column `col`, for every right-hand side."""
    nb = excess.shape[1]
    q = lambda t, k: Fraction(float(t[cat, k, col, 0]))
    lo = [q(lower, k) for k in range(nb)]
    up = [q(upper, k) for k in range(nb)]
    dg = [q(excess, k) - (up[k - 1] if k else 0)
          - (lo[k + 1] if k < nb - 1 else 0) for k in range(nb)]
    out = []
    for t in range(rhs.shape[0]):
        r = [Fraction(float(rhs[t, cat, k, col, 0])) for k in range(nb)]
        cp, dp = [up[0] / dg[0]], [r[0] / dg[0]]
        for k in range(1, nb):
            den = dg[k] - lo[k] * cp[k - 1]
            cp.append(up[k] / den)
            dp.append((r[k] - lo[k] * dp[k - 1]) / den)
        x = [dp[-1]]
        for k in range(nb - 2, -1, -1):
            x.insert(0, dp[k] - cp[k] * x[0])
        out.append([float(v) for v in x])
    return np.array(out)


def _c2_step(dtype, monkeypatch, bf16=False):
    """step_zbgc on the five columns, and the arguments and result of its
    tridiagonal solve."""
    tzc, _ = _zcfgs(**BGCZ)
    names = tz.z_tracer_names(tzc)
    seen = {}
    solve = tz.tridiag_solve

    def spy(*args):
        seen["args"] = args + (solve(*args),)
        return seen["args"][-1]

    monkeypatch.setattr(tz, "tridiag_solve", spy)
    out = tz.step_zbgc(tzc, DT, **_c2_inputs(dtype, names, bf16))
    return out, seen["args"], names


def test_thin_brine_column_is_finite_in_float32(monkeypatch):
    """The float32 step holds every field of the five columns within
    C2_F32 of the mended float64, the thin column c0 too; the columns'
    inputs rounded to bfloat16 do not."""
    o64, _, names = _c2_step("float64", monkeypatch)
    o32, _, _ = _c2_step("float32", monkeypatch)
    o16, _, _ = _c2_step("float32", monkeypatch, bf16=True)

    def worst(o, col):
        return max(float((o.trc[n][:, :, col].double()
                          - o64.trc[n][:, :, col]).abs().max()
                         / o64.trc[n][:, :, col].abs().max().clamp(
                             min=1e-300)) for n in names)

    for col in range(5):
        assert all(bool(torch.isfinite(o32.trc[n]).all()) for n in names)
        assert worst(o32, col) <= C2_F32, col
        assert worst(o16, col) > 10 * C2_F32, col


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_thin_brine_column_solves_its_system_exactly(dtype, monkeypatch):
    """On c0 the subtraction-free elimination gives the exact solution
    of the transport's system to C2_SOLVE, though its
    couplings reach 1.8e20 (the direct form's pivot cancels there); the
    system's coefficients rounded to bfloat16 do not."""
    _, (lower, upper, excess, rhs, x), _ = _c2_step(dtype, monkeypatch)
    assert float((-lower[:, :, 0]).max()) > 1e19
    coarse = tz.tridiag_solve(*(t.to(torch.bfloat16).to(t.dtype)
                                for t in (lower, upper, excess, rhs)))
    far = 0.0
    for cat in range(NCAT):
        ex = _exact_solve(lower, upper, excess, rhs, cat, 0)
        scale = np.maximum(np.abs(ex), 1e-300)
        got = x[:, cat, :, 0, 0].double().numpy()
        assert float((np.abs(got - ex) / scale).max()) <= C2_SOLVE[dtype]
        far = max(far, float((np.abs(coarse[:, cat, :, 0, 0].double()
                                     .numpy() - ex) / scale).max()))
    assert far > 10 * C2_SOLVE["float32"]


def test_sound_columns_match_jax_and_the_thin_one_departs(monkeypatch):
    """In float64 every category of the five columns whose brine column
    holds z tracers (at least HBR_BIO_MIN) equals the JAX package's
    step_zbgc to its engine-vs-engine 1e-12. The first category of each
    column is thin (c0's melted through, c1-c4's brine 2.0-2.4 mm): the
    port takes the thin-brine-column rule there, the mixed layer's
    concentrations; the JAX package, which lacks the rule, carries the
    contents over a height near zero (1e10-1e14 mmol/m^3), and on c0 its
    direct-form solve cancels its pivot: a departure logged under
    ROADMAP's "Reference faults not copied"."""
    tzc, jzc = _zcfgs(**BGCZ)
    got, _, names = _c2_step("float64", monkeypatch)
    kw = _c2_inputs("float64", names)
    with jax.disable_jit():
        ref = jz.step_zbgc(jzc, DT, **{
            k: ({n: jnp.asarray(v.numpy()) for n, v in a.items()}
                if isinstance(a, dict) else jnp.asarray(a.numpy()))
            for k, a in kw.items()})
    a, v = kw["aicen"].numpy(), kw["vicen"].numpy()
    ice = a > 1e-11
    hbr = np.where(ice, v / np.maximum(a, 1e-11), 0.0) * np.clip(
        kw["fbri"].numpy(), 0.0, 1.2)
    held = ice & (hbr >= tz.HBR_BIO_MIN)
    thin = ice & ~held
    assert thin[0].all() and not thin[1:].any()
    held_b = np.broadcast_to(held[:, None], got.trc[names[0]].shape)
    far = 0.0
    for n in names:
        g, r = got.trc[n].numpy(), np.asarray(ref.trc[n])
        _close(g[held_b], r[held_b], f"held categories {n}", "float64")
        assert (g[0] == tz.ocean_concentration(tzc, n)).all(), n
        far = max(far, float(np.abs(r[0]).max()))
    assert far > 1e10


def test_thin_brine_columns_give_the_ocean_what_they_held():
    """Under the thin-brine-column rule a column keeps its budget: what
    its z tracers held over its brine height, and its snow reservoirs,
    less what it holds after (the mixed layer's concentrations), is what
    its flux to the ocean carries in the step. Every category of c0 made
    thin (its ice at a tenth of its volume), with snow reservoirs and no
    snow, so that the reservoirs empty into the column."""
    tzc, _ = _zcfgs(**{**BGCZ, "zbgc.solve_zbgc": False})
    names = tz.z_tracer_names(tzc)
    kw = _c2_inputs("float64", names)
    kw = {k: (({n: x[:, :, :1] for n, x in t.items()} if k != "snow"
               else {n: x[:, :1] for n, x in t.items()})
              if isinstance(t, dict) else t) for k, t in kw.items()}
    for k in ("aicen", "vicen", "vsnon", "fbri", "darcy_V", "fswthru",
              "meltt", "meltb", "congel", "melts"):
        kw[k] = kw[k][:, :1]
    for k in ("qice", "sice"):
        kw[k] = kw[k][:, :, :1]
    kw["Tbot"], kw["frazil"] = kw["Tbot"][:1], kw["frazil"][:1]
    kw["vicen"] = 0.001 * kw["aicen"]
    kw["fbri"] = torch.ones_like(kw["fbri"])
    kw["snow"] = {n: torch.full_like(kw["aicen"], 0.5 + i)
                  for i, n in enumerate(names)}
    out = tz.step_zbgc(tzc, DT, **kw)
    a, hbr = kw["aicen"], kw["vicen"] / kw["aicen"]
    assert bool((hbr < tz.HBR_BIO_MIN).all())
    for n in names:
        before = a * (kw["trc"][n].clamp(min=0.0).mean(1) * hbr
                      + kw["snow"][n])
        after = a * (out.trc[n].mean(1) * hbr + out.snow[n])
        assert bool((out.trc[n] == tz.ocean_concentration(tzc, n)).all())
        np.testing.assert_allclose(
            (out.flux_ocn[n] * DT).numpy(), (before - after).sum(0).numpy(),
            rtol=1e-12, err_msg=n)
