"""PyTorch port vs JAX package: the floe size distribution and the wave
spectra (cice_tpu_torch/columns/fsd.py, model/forcing.py wave functions
and io/forcing_files.WaveSpecDataset against cice_tpu/columns/fsd.py,
cice_tpu/model/forcing.py and cice_tpu/io/forcing_files.py), on the same
numpy inputs made from a seed (ncat=5, nfsd=12, 24x16 cells, CPU), with a
wave-spectrum file written here.

The JAX reference runs op by op (jax.disable_jit), so neither side
contracts float32 products into fused multiply-adds.

Tolerances. f64: 1e-12 of each field's largest value, and the fracture
histogram exactly (its entries are sums of gaps, multiples of 25 m). f32:
the fracture marks (strain > EPS_CRIT, local maxima) are knife edges that
a 1-ulp change of the strain flips, and a flipped mark moves the histogram
by a whole gap; the f32 test bounds the counted difference: the two
packages' histograms may differ in at most 1 % of the cells, and the FSD
after fracture within 1e-5 of its largest value elsewhere.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.columns import fsd as jfsd  # noqa: E402
from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from cice_tpu.model import forcing as jforcing  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.columns import fsd as tfsd  # noqa: E402
from cice_tpu_torch.config import Config as TConfig  # noqa: E402
from cice_tpu_torch.core.grid import make_grid as tmake_grid  # noqa: E402
from cice_tpu_torch.model import forcing as tforcing  # noqa: E402

NCAT, NFSD, NY, NX = 5, 12, 16, 24
DT = 3600.0
RTOL = {"float64": 1e-12, "float32": 1e-5}


def _close_tree(got, ref, what, rtol):
    g, r = convert.tree_to_numpy(got), convert.tree_to_numpy(ref)
    assert g.keys() == r.keys(), what
    for k in r:
        a, b = np.asarray(g[k]), np.asarray(r[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        scale = max(float(np.abs(b).max()), 1e-300)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale,
                                   err_msg=f"{what}: {k}")


def _cfgs(**over):
    over = {"tracers.tr_fsd": True, "domain.nfsd": NFSD, **over}
    return JConfig().with_overrides(**over), TConfig().with_overrides(**over)


def _fsd_inputs(rng, dtype):
    shp = (NCAT, NY, NX)
    aicen = 0.19 * rng.random(shp) * (rng.random(shp) > 0.2)
    fsd = rng.random((NCAT, NFSD, NY, NX)) ** 3
    fsd /= fsd.sum(1, keepdims=True)
    frzmlt = 200.0 * rng.random((NY, NX)) - 100.0
    kw = dict(fsd=fsd, aicen=aicen, vicen=aicen * 3.0 * rng.random(shp),
              da_new=np.where(rng.random(shp) > 0.5,
                              0.05 * rng.random(shp), 0.0),
              frzmlt=frzmlt, G_rad=(np.sign(frzmlt) * np.abs(frzmlt) *
                                    1e-8)[None])
    return {k: v.astype(dtype) for k, v in kw.items()}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_wave_frequencies_equal_jax_bit_for_bit(dtype):
    with jax.disable_jit():
        jf, jdf = jforcing.wave_frequencies(getattr(jnp, dtype))
    tf, tdf = tforcing.wave_frequencies(getattr(torch, dtype))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tdf.numpy(), np.asarray(jdf))
    for a, b in zip(tfsd.fsd_bounds(NFSD), jfsd.fsd_bounds(NFSD)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tfsd.fsd_bounds(16), jfsd.fsd_bounds(16)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_step_fsd_thermo_matches_jax(dtype):
    kw = _fsd_inputs(np.random.default_rng(90), dtype)
    jcfg, tcfg = _cfgs()
    args = {k: kw[k] for k in ("fsd", "aicen", "da_new", "G_rad", "frzmlt")}
    with jax.disable_jit():
        ref = jfsd.step_fsd_thermo(jcfg, DT, return_tend=True,
                                   **{k: jnp.asarray(v)
                                      for k, v in args.items()})
    got = tfsd.step_fsd_thermo(tcfg, DT, return_tend=True,
                               **{k: torch.as_tensor(v)
                                  for k, v in args.items()})
    _close_tree(got, ref, f"step_fsd_thermo {dtype}", RTOL[dtype])
    t = convert.tree_to_numpy(ref[1])
    assert np.abs(t["dafsd_weld"]).max() > 0.0
    assert np.abs(t["dafsd_latg"]).max() > 0.0
    assert np.abs(t["dafsd_latm"]).max() > 0.0


def _wave_state(rng, dtype):
    """Wind seas from calm to a gale over mixed ice; the spectrum from the
    JAX package's profile."""
    wind = (30.0 * rng.random((NY, NX))).astype(dtype)
    aice = rng.random((NY, NX)).astype(dtype)
    with jax.disable_jit():
        E = jforcing.bretschneider_spectrum(
            jnp.asarray(0.0248 * wind ** 2 * np.clip(1.0 - aice, 0, 1)),
            jnp.maximum(0.729 * jnp.asarray(wind), 2.0))
    hs = np.asarray(4.0 * jnp.sqrt(jnp.sum(
        E * jforcing.wave_frequencies(getattr(jnp, dtype))[1][:, None, None],
        axis=0)))
    return np.array(E), hs, np.maximum(0.729 * wind, 2.0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_wave_fracture_histogram_and_step_dyn_wave_match_jax(dtype):
    rng = np.random.default_rng(91)
    kw = _fsd_inputs(rng, dtype)
    E, hs, Tp = _wave_state(rng, dtype)
    jcfg, tcfg = _cfgs(**{"forcing.wave_spec_type": "profile"})
    hbar = (kw["vicen"].sum(0) / np.maximum(kw["aicen"].sum(0), 1e-11)
            ).astype(dtype)
    with jax.disable_jit():
        jf, jdf = jforcing.wave_frequencies(getattr(jnp, dtype))
        jW = np.asarray(jfsd.wave_frac_histogram(
            jnp.asarray(E), jdf, jf, jnp.asarray(hbar), NFSD))
        ref = jfsd.step_dyn_wave(
            jcfg, DT, fsd=jnp.asarray(kw["fsd"]),
            aicen=jnp.asarray(kw["aicen"]), vicen=jnp.asarray(kw["vicen"]),
            hs_wave=jnp.asarray(hs), Tp_wave=jnp.asarray(Tp),
            wave_spectrum=jnp.asarray(E), return_tend=True)
    tf, tdf = tforcing.wave_frequencies(getattr(torch, dtype))
    tW = tfsd.wave_frac_histogram(torch.as_tensor(E), tdf, tf,
                                  torch.as_tensor(hbar), NFSD).numpy()
    got = tfsd.step_dyn_wave(
        tcfg, DT, fsd=torch.as_tensor(kw["fsd"]),
        aicen=torch.as_tensor(kw["aicen"]),
        vicen=torch.as_tensor(kw["vicen"]), hs_wave=torch.as_tensor(hs),
        Tp_wave=torch.as_tensor(Tp), wave_spectrum=torch.as_tensor(E),
        return_tend=True)
    assert jW.max() > 0.0 and (jW > 0).any(axis=0).mean() > 0.2
    differs = (tW != jW).any(axis=0)
    if dtype == "float64":
        np.testing.assert_array_equal(tW, jW)
        _close_tree(got, ref, "step_dyn_wave f64", RTOL[dtype])
    else:
        assert differs.mean() <= 0.01, differs.sum()
        g, r = convert.tree_to_numpy(got), convert.tree_to_numpy(ref)
        for k in r:
            a, b = np.asarray(g[k]), np.asarray(r[k])
            keep = ~np.broadcast_to(differs, a.shape)
            scale = float(np.abs(b).max())
            np.testing.assert_allclose(a[keep], b[keep], rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_wave_fracture_without_a_spectrum_matches_jax(dtype):
    rng = np.random.default_rng(92)
    kw = _fsd_inputs(rng, dtype)
    hs = (4.0 * rng.random((NY, NX))).astype(dtype)
    Tp = (2.0 + 12.0 * rng.random((NY, NX))).astype(dtype)
    jcfg, tcfg = _cfgs()
    with jax.disable_jit():
        ref = jfsd.step_dyn_wave(
            jcfg, DT, fsd=jnp.asarray(kw["fsd"]),
            aicen=jnp.asarray(kw["aicen"]), vicen=jnp.asarray(kw["vicen"]),
            hs_wave=jnp.asarray(hs), Tp_wave=jnp.asarray(Tp),
            return_tend=True)
    got = tfsd.step_dyn_wave(
        tcfg, DT, fsd=torch.as_tensor(kw["fsd"]),
        aicen=torch.as_tensor(kw["aicen"]),
        vicen=torch.as_tensor(kw["vicen"]), hs_wave=torch.as_tensor(hs),
        Tp_wave=torch.as_tensor(Tp), return_tend=True)
    _close_tree(got, ref, f"step_dyn_wave no spectrum {dtype}", RTOL[dtype])
    assert np.abs(np.asarray(ref[1]["dafsd_wave"])).max() > 0.0


@pytest.fixture(scope="module")
def grids():
    over = {"grid.nx_global": NX, "grid.ny_global": NY,
            "tracers.tr_fsd": True, "domain.nfsd": NFSD}
    jc, tc = JConfig().with_overrides(**over), \
        TConfig().with_overrides(**over)
    return jc, tc


@pytest.mark.parametrize("wst", ["constant", "profile", "random", "file"])
def test_get_forcing_wave_spectra_match_jax(grids, wst, tmp_path):
    """get_forcing's wave branch, f64: the Bretschneider profile of the
    local wind sea for 'constant', 'profile' and 'random', and a wave
    model's monthly spectra from a file written here for 'file' (its
    dataset kept on the caller's datasets, under 'wave')."""
    jc, tc = grids
    rng = np.random.default_rng(93)
    path = str(tmp_path / "wave_spec.npz")
    np.savez(path, efreq=(0.5 * rng.random((12, 25, NY, NX))).astype(
        np.float32))
    over = {"forcing.wave_spec_type": wst, "forcing.wave_spec_file": path}
    jc, tc = jc.with_overrides(**over), tc.with_overrides(**over)
    jg, tg = jmake_grid(jc), tmake_grid(tc, "cpu")
    aice = 0.9 * rng.random((NY, NX))
    datasets = {}
    for yday in (10.0, 45.0):
        ref = jforcing.get_forcing(jc, jg, 0.0, yday, jnp.asarray(aice))
        got = tforcing.get_forcing(tc, tg, 0.0, yday, torch.as_tensor(aice),
                                   datasets=datasets)
        for k in ("wave_hs", "wave_Tp", "wave_spectrum"):
            a, b = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
            np.testing.assert_allclose(a, b, rtol=1e-12,
                                       atol=1e-12 * float(np.abs(b).max()),
                                       err_msg=f"{wst} {k}")
        assert float(np.asarray(ref.wave_hs).max()) > 0.1
    assert list(datasets) == (["wave"] if wst == "file" else [])
    if wst == "file":
        assert os.path.samefile(datasets["wave"].path, path)
