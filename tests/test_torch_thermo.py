"""PyTorch port vs JAX package: the column thermodynamics of step_therm1,
module by module, on the same numpy inputs made from a seed (ncat=5,
24x16 cells, f64, CPU): the BL99 temperature solve and the growth/melt
bookkeeping (columns/thermo_vertical), the Monin-Obukhov boundary layer
(columns/atmo), the ccsm3 shortwave (columns/shortwave), the level-ice
ponds (columns/ponds) and the slab ocean (columns/ocean).

Tolerance: f64, 1e-10 of each field's largest value. Both packages evaluate
the same expressions in the same order; exp/log/atan/pow come from
different math libraries (~1e-16), which the Picard iteration and the layer
eliminations amplify by a few orders at most. The Picard loop's global exit
test must stop both after the same number of passes for that to hold.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.columns import atmo as jatmo  # noqa: E402
from cice_tpu.columns import ocean as jocean  # noqa: E402
from cice_tpu.columns import ponds as jponds  # noqa: E402
from cice_tpu.columns import shortwave as jsw  # noqa: E402
from cice_tpu.columns import thermo_vertical as jtv  # noqa: E402
from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.columns import atmo as tatmo  # noqa: E402
from cice_tpu_torch.columns import ocean as tocean  # noqa: E402
from cice_tpu_torch.columns import ponds as tponds  # noqa: E402
from cice_tpu_torch.columns import shortwave as tsw  # noqa: E402
from cice_tpu_torch.columns import thermo_vertical as ttv  # noqa: E402
from cice_tpu_torch.config import Config as TConfig  # noqa: E402

NCAT, NY, NX = 5, 16, 24
NILYR, NSLYR = 7, 1
DT = 3600.0
RTOL = 1e-10


def T(a):
    return torch.as_tensor(np.array(a))   # a writable copy


def _close(got, ref, name, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


def _close_tree(got, ref, what, rtol=RTOL):
    g, r = convert.tree_to_numpy(got), convert.tree_to_numpy(ref)
    assert g.keys() == r.keys(), (what, g.keys() ^ r.keys())
    for k in r:
        _close(g[k], r[k], f"{what}: {k}", rtol)


def _forcing(rng):
    """Atmosphere planes (ny, nx): a cold half and a melting half."""
    warm = (np.arange(NX)[None, :] >= NX // 2) * np.ones((NY, 1))
    r = lambda lo, hi: lo + (hi - lo) * rng.random((NY, NX))
    return dict(
        potT=np.where(warm, r(272.0, 279.0), r(245.0, 268.0)),
        Qa=r(4e-4, 3e-3), rhoa=r(1.25, 1.4),
        flw=np.where(warm, r(280.0, 360.0), r(160.0, 260.0)),
        uatm=r(-8.0, 8.0), vatm=r(-8.0, 8.0), zlvl=np.full((NY, NX), 10.0),
        swvdr=warm * r(0.0, 120.0), swvdf=warm * r(0.0, 80.0),
        swidr=warm * r(0.0, 100.0), swidf=warm * r(0.0, 60.0),
        frain=warm * r(0.0, 2e-5), fsnow=(1 - warm) * r(0.0, 3e-5))


def _columns(rng):
    """Per-category column state (ncat, ny, nx): thick and thin ice, with
    snow, without, and with snow thinner than hs_min."""
    shp = (NCAT, NY, NX)
    hin = 0.05 + 3.0 * rng.random(shp)
    kind = rng.integers(0, 3, shp)
    hsn = np.where(kind == 0, 0.0,
                   np.where(kind == 1, 1e-6 * rng.random(shp),
                            0.02 + 0.4 * rng.random(shp)))
    Tsf = -30.0 * rng.random(shp) - 0.2
    salin = jtv.bl99_salinity(NILYR)
    Tm = jtv.melting_temps(salin)
    Tlay = [np.minimum(-1.0 - 15.0 * rng.random(shp), Tm[k] - 0.3)
            for k in range(NILYR)]
    qice = [np.asarray(jtv.enthalpy_ice(jnp.asarray(Tlay[k]), float(Tm[k])))
            for k in range(NILYR)]
    qsno = [np.asarray(jtv.enthalpy_snow(jnp.asarray(
        -1.0 - 20.0 * rng.random(shp))))]
    return dict(hin=hin, hsn=hsn, Tsf=Tsf, qice=qice, qsno=qsno,
                salin=[float(s) for s in salin], Tm=[float(t) for t in Tm])


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(20)
    return _forcing(rng), _columns(rng)


@pytest.mark.parametrize("over", ["ice", "ocn"])
def test_atmo_boundary_layer_matches_jax(inputs, over):
    fc, col = inputs
    wind = np.hypot(fc["uatm"], fc["vatm"])
    Tsf = col["Tsf"] if over == "ice" else col["Tsf"][0] * 0.05
    args = (Tsf, fc["potT"], fc["uatm"], fc["vatm"], wind, fc["zlvl"],
            fc["Qa"], fc["rhoa"])
    ref = jax.jit(lambda *a: jatmo.atmo_boundary_layer(
        *a, natmiter=5, over=over))(*map(jnp.asarray, args))
    got = tatmo.atmo_boundary_layer(*map(T, args), natmiter=5, over=over)
    _close_tree(got, ref, f"atmo over {over}")


def test_atmo_boundary_const_and_surface_fluxes_match_jax(inputs):
    fc, col = inputs
    wind = np.hypot(fc["uatm"], fc["vatm"])
    a = (col["Tsf"], fc["uatm"], fc["vatm"], wind, fc["rhoa"], fc["Qa"])
    ref = jatmo.atmo_boundary_const(*map(jnp.asarray, a))
    got = tatmo.atmo_boundary_const(*map(T, a))
    _close_tree(got, ref, "atmo const")
    b = (col["Tsf"], np.asarray(ref.shcoef), np.asarray(ref.lhcoef),
         fc["potT"], fc["Qa"], fc["rhoa"], fc["flw"], fc["swvdr"])
    _close_tree(tatmo.surface_fluxes(*map(T, b)),
                jatmo.surface_fluxes(*map(jnp.asarray, b)), "surface_fluxes")


def test_shortwave_ccsm3_matches_jax(inputs):
    fc, col = inputs
    a = (col["Tsf"], col["hin"], col["hsn"], fc["swvdr"], fc["swvdf"],
         fc["swidr"], fc["swidf"])
    ref = jax.jit(lambda *x: jsw.shortwave_ccsm3(
        *x, JConfig().shortwave, NILYR))(*map(jnp.asarray, a))
    got = tsw.shortwave_ccsm3(*map(T, a), TConfig().shortwave, NILYR)
    _close_tree(got, ref, "shortwave_ccsm3")
    assert float(np.asarray(ref.fswthru).max()) > 0.0


def _therm_args(fc, col):
    """Arguments of temperature_changes as numpy, with the boundary-layer
    coefficients and shortwave partition of the JAX package."""
    J = jnp.asarray
    wind = np.hypot(fc["uatm"], fc["vatm"])
    co = jatmo.atmo_boundary_layer(
        J(col["Tsf"]), J(fc["potT"]), J(fc["uatm"]), J(fc["vatm"]), J(wind),
        J(fc["zlvl"]), J(fc["Qa"]), J(fc["rhoa"]), natmiter=5)
    sw = jsw.shortwave_ccsm3(J(col["Tsf"]), J(col["hin"]), J(col["hsn"]),
                             J(fc["swvdr"]), J(fc["swvdf"]), J(fc["swidr"]),
                             J(fc["swidf"]), JConfig().shortwave, NILYR)
    return dict(
        Tsf=col["Tsf"], qsno=col["qsno"], qice=col["qice"],
        hilyr=np.maximum(col["hin"], 0.01) / NILYR, hslyr=col["hsn"] / NSLYR,
        Tbot=np.full((NY, NX), -1.8), fswsfc=np.asarray(sw.fswsfc),
        Iswabs=[np.asarray(sw.Iswabs[:, k]) for k in range(NILYR)],
        shcoef=np.asarray(co.shcoef), lhcoef=np.asarray(co.lhcoef),
        potT=fc["potT"], Qa=fc["Qa"], rhoa=fc["rhoa"], flw=fc["flw"])


def _map(fn, d):
    return {k: ([fn(x) for x in v] if isinstance(v, list) else fn(v))
            for k, v in d.items()}


@pytest.fixture(scope="module")
def temp_solve(inputs):
    """The JAX temperature solve on the module's inputs (one compile)."""
    fc, col = inputs
    kw = _therm_args(fc, col)
    static = dict(salin=col["salin"], Tm=col["Tm"], conduct="bubbly", nit=50)
    ref = jax.jit(lambda a: jtv.temperature_changes(
        DT, NILYR, NSLYR, **a, **static))(_map(jnp.asarray, kw))
    return kw, static, ref


def test_temperature_changes_matches_jax(temp_solve):
    kw, static, ref = temp_solve
    got = ttv.temperature_changes(DT, NILYR, NSLYR, **_map(T, kw), **static)
    _close_tree(got, ref, "temperature_changes")
    ts = ref[0]
    # both surface closures and the sub-hs_min snow guard are exercised
    assert float(np.asarray(ts.Tsf).max()) == 0.0
    assert float(np.asarray(ts.Tsf).min()) < -5.0
    assert np.isfinite(np.asarray(ts.fcondtop)).all()


def test_thickness_changes_and_adjust_enthalpy_match_jax(inputs, temp_solve):
    fc, col = inputs
    _, _, (ts, qsno_new, qice_new) = temp_solve
    N = np.asarray
    kw = dict(hin=np.maximum(col["hin"], 0.01), hsn=col["hsn"],
              qice=[N(q) for q in qice_new], qsno=[N(q) for q in qsno_new],
              Tbot=np.full((NY, NX), -1.8),
              fbot=-30.0 * np.random.default_rng(21).random((NY, NX)),
              fsurf=N(ts.fsurf), fcondtop=N(ts.fcondtop),
              fcondbot=N(ts.fcondbot), flat=N(ts.flat),
              sss=np.full((NY, NX), 34.0))
    static = dict(Tm=col["Tm"], salin=col["salin"])
    ref = jax.jit(lambda a: jtv.thickness_changes(
        DT, NILYR, NSLYR, **a, **static))(_map(jnp.asarray, kw))
    got = ttv.thickness_changes(DT, NILYR, NSLYR, **_map(T, kw), **static)
    _close_tree(got, ref, "thickness_changes")
    th, dzi, _ = ref
    for k in ("meltt", "meltb", "congel", "melts"):
        assert float(N(getattr(th, k)).max()) > 0.0, k
    jq = jtv.adjust_enthalpy(list(dzi), list(th.qice), NILYR, th.hin)
    tq = ttv.adjust_enthalpy([T(N(d)) for d in dzi],
                             [T(N(q)) for q in th.qice], NILYR, T(N(th.hin)))
    _close_tree(tq, jq, "adjust_enthalpy")


def test_tridiag_solve_matches_jax():
    rng = np.random.default_rng(22)
    n, shp = 9, (3, 5, 6)
    sb = [rng.random(shp) for _ in range(n)]
    sp = [rng.random(shp) for _ in range(n)]
    dg = [3.0 + rng.random(shp) for _ in range(n)]
    rh = [rng.random(shp) for _ in range(n)]
    jx = jtv.tridiag_solve(*[[jnp.asarray(a) for a in v]
                             for v in (sb, dg, sp, rh)])
    tx = ttv.tridiag_solve(*[[T(a) for a in v] for v in (sb, dg, sp, rh)])
    _close_tree(tx, jx, "tridiag_solve", 1e-13)


def test_step_ponds_matches_jax(inputs):
    fc, col = inputs
    rng = np.random.default_rng(23)
    shp = (NCAT, NY, NX)
    aicen = 0.19 * rng.random(shp) * (rng.random(shp) > 0.2)
    kw = dict(aicen=aicen, vicen=aicen * col["hin"], vsnon=aicen * col["hsn"],
              Tsf=np.where(rng.random(shp) > 0.5, 0.0, col["Tsf"]),
              meltt=0.01 * rng.random(shp), melts=0.02 * rng.random(shp),
              frain=fc["frain"], aice=aicen.sum(0))
    trcrn = dict(alvl=rng.random(shp), apnd=0.5 * rng.random(shp),
                 hpnd=0.3 * rng.random(shp), ipnd=0.05 * rng.random(shp))
    ref = jax.jit(lambda a, t: jponds.step_ponds(
        JConfig(), DT, trcrn=t, return_diag=True, **a))(
            _map(jnp.asarray, kw), _map(jnp.asarray, trcrn))
    got = tponds.step_ponds(TConfig(), DT, trcrn=_map(T, trcrn),
                            return_diag=True, **_map(T, kw))
    _close_tree(got, ref, "step_ponds")
    assert float(np.asarray(ref[2]).max()) > 0.0      # some pond flushes
    mj = jponds.pond_reservoir_mass(ref[0], jnp.asarray(aicen), True)
    mt = tponds.pond_reservoir_mass(got[0], T(aicen), True)
    _close(mt, mj, "pond_reservoir_mass")


def test_ocean_mixed_layer_matches_jax(inputs):
    fc, _ = inputs
    rng = np.random.default_rng(24)
    r = lambda lo, hi: lo + (hi - lo) * rng.random((NY, NX))
    kw = dict(sst=r(-1.8, -1.79), Tf=np.full((NY, NX), -1.8),
              hmix=r(10.0, 40.0), qdp=r(-5.0, 5.0), frzmlt_old=r(-50, 50),
              aice=r(0.0, 1.0), fhocn_ice=r(-40.0, 5.0),
              fswthru_ice=r(0.0, 10.0), flw=fc["flw"], swvdr=fc["swvdr"],
              swvdf=fc["swvdf"], swidr=fc["swidr"], swidf=fc["swidf"],
              potT=fc["potT"], Qa=fc["Qa"], rhoa=fc["rhoa"],
              wind=np.hypot(fc["uatm"], fc["vatm"]), uatm=fc["uatm"],
              vatm=fc["vatm"], zlvl=fc["zlvl"])
    ref = jax.jit(lambda a: jocean.ocean_mixed_layer(
        DT, fresh_unused=0.0, **a))(_map(jnp.asarray, kw))
    got = tocean.ocean_mixed_layer(DT, fresh_unused=0.0, **_map(T, kw))
    _close_tree(got, ref, "ocean_mixed_layer")
    frz = np.asarray(ref[1])
    assert frz.max() > 0.0 > frz.min()
