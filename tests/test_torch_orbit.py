"""PyTorch port vs JAX package: the orbit (cice_tpu_torch.columns.orbit)
and the analytic forcing modes of cice_tpu_torch.model.forcing (uniform and
calm winds, the file-less seasonal cycle), on a small lat-lon grid.

Tolerance: f64 at rtol 1e-12 of each field's largest value (the same
expressions; math-library differences of an ulp or two). The orbital
parameters are Python floats on both sides and must be equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax.numpy as jnp  # noqa: E402

from cice_tpu.columns import orbit as jorbit  # noqa: E402
from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from cice_tpu.model import forcing as jforcing  # noqa: E402
from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch.columns import orbit as torbit  # noqa: E402
from cice_tpu_torch.core.grid import make_grid as tmake_grid  # noqa: E402
from cice_tpu_torch.model import forcing as tforcing  # noqa: E402

RTOL = 1e-12
GRID = {"grid.grid_format": "latlon", "grid.nx_global": 24,
        "grid.ny_global": 20, "dtype": "float64"}


def _close(got, ref, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale,
                               err_msg=name)


def _forcing_close(tfc, jfc, what):
    for f in dataclasses.fields(jfc):
        ref = np.asarray(getattr(jfc, f.name))
        if ref.size:
            _close(getattr(tfc, f.name), ref, f"{what}: {f.name}")


@pytest.fixture(scope="module")
def grids():
    over = dict(GRID)
    return (tconfig.Config().with_overrides(**over),
            JConfig().with_overrides(**over))


@pytest.mark.parametrize("year", [1850, 2000, 2005, 2100])
def test_orb_params_and_declination(year):
    t, j = torbit.orb_params(year), jorbit.orb_params(year)
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    assert (t.obliqr, t.mvelpp, t.lambm0) == (j.obliqr, j.mvelpp, j.lambm0)
    for calday in (1.0, 80.5, 172.25, 355.9):
        decl, eccf = torbit.solar_declination(calday, t)
        jdecl, jeccf = jorbit.solar_declination(calday, j)
        assert decl == pytest.approx(float(jdecl), rel=RTOL, abs=1e-15)
        assert eccf == pytest.approx(float(jeccf), rel=RTOL)


@pytest.mark.parametrize("daily_mean", [True, False])
def test_compute_coszen(daily_mean):
    rng = np.random.default_rng(1)
    lat = np.deg2rad(rng.uniform(-89.0, 89.0, (20, 24)))
    lon = np.deg2rad(rng.uniform(0.0, 360.0, (20, 24)))
    p = torbit.orb_params(1990)
    jp = jorbit.orb_params(1990)
    for calday in np.linspace(1.0, 365.9, 9):
        c, e = torbit.compute_coszen(torch.as_tensor(lat),
                                     torch.as_tensor(lon), float(calday), p,
                                     daily_mean=daily_mean)
        jc, je = jorbit.compute_coszen(jnp.asarray(lat), jnp.asarray(lon),
                                       float(calday), jp,
                                       daily_mean=daily_mean)
        _close(c, jc, f"coszen day {calday}")
        assert e == pytest.approx(float(je), rel=RTOL)


@pytest.mark.parametrize("mode", ["fixed_year", "fixed_parameters"])
def test_default_coszen_follows_the_orbit_options(grids, mode):
    tcfg, jcfg = grids
    over = {"forcing.orb_mode": mode, "forcing.orb_iyear": 1950}
    tcfg, jcfg = tcfg.with_overrides(**over), jcfg.with_overrides(**over)
    tg, jg = tmake_grid(tcfg, "cpu"), jmake_grid(jcfg)
    c, e = tforcing.default_coszen(tg, 100.5, cfg=tcfg)
    jc, je = jforcing.default_coszen(jg, 100.5, cfg=jcfg)
    _close(c, jc, mode)
    assert e == pytest.approx(float(je), rel=RTOL)


@pytest.mark.parametrize("atm", list(tforcing.UNIFORM))
def test_uniform_and_calm_winds(grids, atm):
    tcfg, jcfg = grids
    over = {"forcing.atm_data_type": atm}
    tcfg, jcfg = tcfg.with_overrides(**over), jcfg.with_overrides(**over)
    tg, jg = tmake_grid(tcfg, "cpu"), jmake_grid(jcfg)
    aice = np.random.default_rng(2).random(tg.shape)
    got = tforcing.get_forcing(tcfg, tg, 3600.0, 1.04, torch.as_tensor(aice),
                               datasets={})
    ref = jforcing.get_forcing(jcfg, jg, 3600.0, 1.04, jnp.asarray(aice))
    _forcing_close(got, ref, atm)
    assert (float(got.wind.max()) > 0.0) == (atm != "calm")


@pytest.mark.parametrize("atm", ["seasonal", "ncar", "jra55"])
def test_seasonal_cycle_over_a_year(grids, atm):
    """The file-less annual cycle, alone ('seasonal') and as the stand-in
    of dataset atmospheres without an atm_data_dir (with uniform_east
    winds of at least 1 m/s), over a year of days."""
    tcfg, jcfg = grids
    over = {"forcing.atm_data_type": atm}
    tcfg, jcfg = tcfg.with_overrides(**over), jcfg.with_overrides(**over)
    tg, jg = tmake_grid(tcfg, "cpu"), jmake_grid(jcfg)
    aice = np.random.default_rng(3).random(tg.shape)
    for yday in np.linspace(1.0, 365.5, 13):
        got = tforcing.get_forcing(tcfg, tg, 0.0, float(yday),
                                   torch.as_tensor(aice), datasets={})
        ref = jforcing.get_forcing(jcfg, jg, 0.0, float(yday),
                                   jnp.asarray(aice))
        _forcing_close(got, ref, f"{atm} day {yday}")
    assert float(got.fsnow.max()) > 0.0 and float(got.frain.max()) > 0.0


def test_unknown_ocean_passes_the_default_ocean_through(grids):
    """ocn_data_type='none' (and 'clim' without a directory) leave the
    ocean fields as they are, as in the JAX package."""
    tcfg, jcfg = grids
    for ocn in ("none", "clim"):
        over = {"forcing.atm_data_type": "calm",
                "forcing.ocn_data_type": ocn}
        tc, jc = tcfg.with_overrides(**over), jcfg.with_overrides(**over)
        tg, jg = tmake_grid(tc, "cpu"), jmake_grid(jc)
        aice = np.zeros(tg.shape)
        got = tforcing.get_forcing(tc, tg, 0.0, 1.0, torch.as_tensor(aice),
                                   datasets={})
        ref = jforcing.get_forcing(jc, jg, 0.0, 1.0, jnp.asarray(aice))
        _forcing_close(got, ref, ocn)
