"""PyTorch port vs JAX package: the advanced snow physics and the
snow-aging table (cice_tpu_torch/columns/snow.py and snowtable.py against
cice_tpu/columns/snow.py and snowtable.py), on the same numpy inputs made
from a seed (ncat=5, nslyr=3, 24x16 cells, CPU), with both tables of
snw_aging_table: the built-in 'test' table and a 'file' table written here.

The JAX reference runs op by op (jax.disable_jit), as tests/
test_torch_eap.py does for EAP's table: the lookup truncates a float to a
table index (searchsorted), and jitted XLA's fused float32 arithmetic moves
the ratios it compares by an ulp.

Tolerances: f64, 1e-12 of each field's largest value; f32, 1e-5 (the
trilinear weights and the power of the FZ06 kernel, a few ulp each).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.columns import snow as jsnow  # noqa: E402
from cice_tpu.columns import snowtable as jtab  # noqa: E402
from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.columns import snow as tsnow  # noqa: E402
from cice_tpu_torch.columns import snowtable as ttab  # noqa: E402
from cice_tpu_torch.config import Config as TConfig  # noqa: E402

NCAT, NSLYR, NY, NX = 5, 3, 16, 24
DT = 3600.0
RTOL = {"float64": 1e-12, "float32": 1e-5}


@pytest.fixture(scope="module")
def table_file(tmp_path_factory):
    """A 'file' aging table: a coarser grid than the test table's, with
    tau and kappa varying over it."""
    rng = np.random.default_rng(70)
    T = np.linspace(-50.0, 0.0, 6)
    Tgrd = np.array([0.0, 10.0, 40.0, 100.0, 300.0])
    rhos = np.linspace(50.0, 450.0, 4)
    shp = (T.size, Tgrd.size, rhos.size)
    path = str(tmp_path_factory.mktemp("snowtable") / "aging.npz")
    np.savez(path, snw_T=T, snw_Tgrd=Tgrd, snw_rhos=rhos,
             drdt0=0.5 * rng.random(shp), tau=5.0 + 10.0 * rng.random(shp),
             kappa=0.3 + 0.5 * rng.random(shp))
    return path


def _cfgs(kind, path, **over):
    over = {"tracers.tr_snow": True, "domain.nslyr": NSLYR,
            "snow.snwgrain": True, "snow.snwredist": "bulk",
            "snow.snw_aging_table": kind, "snow.snw_filename": path, **over}
    return (JConfig().with_overrides(**over),
            TConfig().with_overrides(**over))


def _inputs(rng, dtype):
    shp, shl = (NCAT, NY, NX), (NCAT, NSLYR, NY, NX)
    aicen = 0.19 * rng.random(shp) * (rng.random(shp) > 0.2)
    hs = 0.4 * rng.random(shp)
    kw = dict(vsnon=aicen * hs, aicen=aicen,
              Tsno=np.where(rng.random(shp) > 0.7, -0.05,
                            -40.0 * rng.random(shp)),
              melts=np.where(rng.random(shp) > 0.6, 0.01 * rng.random(shp),
                             0.0),
              frain=2e-5 * rng.random((NY, NX)),
              fsnow=3e-5 * rng.random((NY, NX)),
              wind=25.0 * rng.random((NY, NX)))
    trcrn = dict(
        smice=np.where(rng.random(shl) > 0.2, 100.0 * rng.random(shl), 0.0),
        smliq=np.where(rng.random(shl) > 0.5, 5.0 * rng.random(shl), 0.0),
        rhos_cmp=100.0 * rng.random(shl),
        rsnw=100.0 + 1000.0 * rng.random(shl),
        alvl=rng.random(shp))
    cast = lambda d: {k: v.astype(dtype) for k, v in d.items()}
    return cast(kw), cast(trcrn)


def _close_tree(got, ref, what, rtol, dtype):
    """Leaf by leaf. The JAX package uploads its tables with jnp.asarray
    of float64 NumPy arrays, which stay float64 when x64 is on, as in this
    test process, and promote a float32 state's radii; without x64 (its
    production setting) they are float32. The port keeps the state's
    dtype, so the reference is cast to it."""
    g, r = convert.tree_to_numpy(got), convert.tree_to_numpy(ref)
    assert g.keys() == r.keys(), what
    for k in r:
        a, b = np.asarray(g[k]), np.asarray(r[k]).astype(dtype)
        assert a.shape == b.shape and a.dtype == np.dtype(dtype), (what, k)
        scale = max(float(np.abs(b).max()), 1e-300)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["exponential", "test", "file"])
def test_step_snow_matches_jax(table_file, kind, dtype):
    kw, trcrn = _inputs(np.random.default_rng(71), dtype)
    jcfg, tcfg = _cfgs(kind, table_file)
    J = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    Tt = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    with jax.disable_jit():
        ref = jsnow.step_snow(jcfg, DT, trcrn=J(trcrn), **J(kw))
    got = tsnow.step_snow(tcfg, DT, trcrn=Tt(trcrn), **Tt(kw))
    _close_tree(got, ref, f"step_snow {kind} {dtype}", RTOL[dtype], dtype)
    r = convert.tree_to_numpy(ref)
    assert float(r["1"].max()) > 0.0                     # liquid drains
    assert float(r["3"].max()) > 0.0                     # wind blows snow
    grown = r["0.rsnw"] - trcrn["rsnw"]
    assert float(grown.max()) > 0.0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_table_lookup_matches_jax_off_and_on_the_nodes(table_file, dtype):
    """The trilinear lookup, below, inside and above each axis and on its
    nodes, for both tables."""
    rng = np.random.default_rng(72)
    for jt, kind, path in ((jtab.make_test_table(), "test", ""),
                           (jtab.load_table_file(table_file), "file",
                            table_file)):
        def pts(ax, n):
            ax = np.asarray(ax)
            inside = ax[0] + (ax[-1] - ax[0]) * rng.random(n)
            return np.concatenate([inside, ax, [ax[0] - 5.0, ax[-1] + 5.0]])
        n = 60
        Ts, G, R = pts(jt.T, n), pts(jt.Tgrd, n), pts(jt.rhos, n)
        m = min(len(Ts), len(G), len(R))
        args = [a[:m].astype(dtype) for a in (Ts, G, R)]
        rsnw = (100.0 + 900.0 * rng.random(m)).astype(dtype)
        with jax.disable_jit():
            ref = jtab.table_aging_rate(jt, *map(jnp.asarray, args),
                                        jnp.asarray(rsnw), 100.0)
        axes, arrays = ttab.device_table(kind, path, getattr(torch, dtype),
                                         "cpu")
        got = ttab.table_aging_rate(axes, arrays,
                                    *map(torch.as_tensor, args),
                                    torch.as_tensor(rsnw), 100.0)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref), rtol=RTOL[dtype],
            atol=RTOL[dtype] * float(np.abs(ref).max()), err_msg=kind)


def test_a_rewritten_table_file_is_read_again(tmp_path):
    path = str(tmp_path / "t.npz")
    ax = dict(snw_T=[-10.0, 0.0], snw_Tgrd=[0.0, 10.0], snw_rhos=[100.0,
                                                                  300.0])
    np.savez(path, drdt0=np.ones((2, 2, 2)), **ax)
    first = ttab.device_table("file", path, torch.float64, "cpu")[1][0]
    np.savez(path, drdt0=np.full((2, 2, 3), 2.0),
             **{**ax, "snw_rhos": [100.0, 200.0, 300.0]})
    second = ttab.device_table("file", path, torch.float64, "cpu")[1][0]
    assert float(first.max()) == 1.0 and float(second.max()) == 2.0
