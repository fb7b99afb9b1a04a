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
    solve; the JAX package solves each alone. A zero pivot takes the
    1e-30 guard in both."""
    rng = np.random.default_rng(71)
    shp = (NCAT, 7, NY, NX)
    lower = -rng.random(shp)
    upper = -rng.random(shp)
    diag = 1.0 + np.abs(lower) + np.abs(upper) + rng.random(shp)
    diag[0, 1, 0, 0] = lower[0, 1, 0, 0] * upper[0, 0, 0, 0] / \
        diag[0, 0, 0, 0]                      # denominator exactly ~0
    rhs = rng.random((5,) + shp)
    c = lambda x: x.astype(dtype)
    with jax.disable_jit():
        ref = np.stack([np.asarray(jz.tridiag_solve(
            *(jnp.asarray(c(x)) for x in (lower, diag, upper, r))))
            for r in rhs])
    got = tz.tridiag_solve(*(torch.as_tensor(c(x)) for x in (lower, diag,
                                                            upper, rhs)))
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got.numpy()), fin)
    _close(np.where(fin, got.numpy(), 0), np.where(fin, ref, 0),
           "tridiag", dtype)
    single = tz.tridiag_solve(*(torch.as_tensor(c(x)) for x in (
        lower, diag, upper, rhs[2])))
    assert torch.equal(single, got[2]) or dtype == "float32"


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
