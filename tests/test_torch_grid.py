"""PyTorch port vs JAX package: halo shifts, grid construction, POP grid
fixtures and inter-grid averaging (cice_tpu_torch.core / .io).

Grid metrics are derived on the host in float64 NumPy by both packages,
so every Grid array must agree to 1e-12; shifts and averages are the same
arithmetic on the same f64 inputs.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cice_tpu.config import Config  # noqa: E402
from cice_tpu.core import grid as jgrid  # noqa: E402
from cice_tpu.core.halo import BC as JBC, shift as jshift  # noqa: E402
from cice_tpu.io import fixtures as jfix  # noqa: E402
from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch.core import grid as tgrid  # noqa: E402
from cice_tpu_torch.core.halo import BC as TBC, shift as tshift  # noqa: E402
from cice_tpu_torch.io import fixtures as tfix  # noqa: E402

BCS = [(ew, ns) for ew in ("cyclic", "open", "closed")
       for ns in ("open", "closed", "cyclic")]
OFFSETS = [(dj, di) for dj in (-2, -1, 0, 1, 2) for di in (-2, -1, 0, 1, 2)]


@pytest.mark.parametrize("ew,ns", BCS)
def test_shift_every_offset(ew, ns):
    f = np.random.default_rng(3).standard_normal((2, 7, 9))
    for dj, di in OFFSETS:
        ref = np.asarray(jshift(jnp.asarray(f), dj, di, bc=JBC(ew, ns)))
        got = tshift(torch.as_tensor(f), dj, di, bc=TBC(ew, ns)).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"{ew}/{ns} {dj},{di}")


@pytest.mark.parametrize("ew,ns", BCS)
def test_neighbors_extrapolate_closed_mask(ew, ns):
    from cice_tpu.core import halo as jh
    from cice_tpu_torch.core import halo as th
    f = np.random.default_rng(5).standard_normal((3, 8, 10))
    jb, tb = JBC(ew, ns), TBC(ew, ns)
    for a, b in zip(th.neighbors4(torch.as_tensor(f), bc=tb),
                    jh.neighbors4(jnp.asarray(f), bc=jb)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        th.extrapolate_edges(torch.as_tensor(f), tb).numpy(),
        np.asarray(jh.extrapolate_edges(jnp.asarray(f), jb)))
    for nrows in (1, 2):
        np.testing.assert_array_equal(
            th.apply_closed_mask(torch.as_tensor(f), tb, nrows).numpy(),
            np.asarray(jh.apply_closed_mask(jnp.asarray(f), jb, nrows)))


def test_shift_tripole_raises():
    with pytest.raises(NotImplementedError, match="tripole and y-cyclic"):
        tshift(torch.zeros(4, 4), 1, 0, bc=TBC("cyclic", "tripole"))


def _assert_grids_equal(tg, jg):
    assert tg.shape == jg.shape and tg.bc.ew == jg.bc.ew and \
        tg.bc.ns == jg.bc.ns
    for k in tgrid.GRID_FIELDS:
        np.testing.assert_allclose(getattr(tg, k).numpy(),
                                   np.asarray(getattr(jg, k)), rtol=0,
                                   atol=1e-12 * max(1.0, float(np.abs(
                                       np.asarray(getattr(jg, k))).max())),
                                   err_msg=k)


@pytest.mark.parametrize("kmt,ew", [("default", "cyclic"),
                                    ("boxislands", "closed"),
                                    ("channel", "open")])
def test_make_grid_rect_matches_jax(kmt, ew):
    over = {"grid.nx_global": 64, "grid.ny_global": 48,
            "grid.kmt_type": kmt, "grid.ew_boundary_type": ew,
            "dtype": "float64"}
    jg = jgrid.make_grid(Config().with_overrides(**over))
    tg = tgrid.make_grid(tconfig.Config().with_overrides(**over),
                         device="cpu")
    assert tg.dtype == torch.float64
    _assert_grids_equal(tg, jg)


def test_make_grid_pop_bin_displaced_pole_matches_jax():
    """The port's slice configuration at test size: its own POP fixture
    files, read by both packages' pop_bin readers."""
    cfg_t = tconfig.gx1pop_dyn(48, 40).with_overrides(dtype="float64")
    g = cfg_t.grid
    cfg_j = Config().with_overrides(**{
        "grid.nx_global": 48, "grid.ny_global": 40,
        "grid.grid_format": "pop_bin", "grid.grid_type": "displaced_pole",
        "grid.grid_file": g.grid_file, "grid.kmt_file": g.kmt_file,
        "dtype": "float64"})
    _assert_grids_equal(tgrid.make_grid(cfg_t, device="cpu"),
                        jgrid.make_grid(cfg_j))
    assert 0.2 < float(np.mean(np.asarray(jgrid.make_grid(cfg_j).hm))) < 0.9


def test_fixture_bytes_identical(tmp_path):
    """Same (nx, ny) -> byte-identical POP grid and kmt files."""
    nx, ny = 36, 30
    ja = jfix.make_displaced_pole_arrays(nx, ny)
    ta = tfix.make_displaced_pole_arrays(nx, ny)
    jfix.write_pop_grid_binary(str(tmp_path / "j_grid.bin"), ja)
    jfix.write_kmt_binary(str(tmp_path / "j_kmt.bin"), ja["kmt"])
    paths = tfix.ensure_displaced_pole_grid(nx, ny, root=str(tmp_path))
    for ours, theirs in ((paths["grid"], "j_grid.bin"),
                         (paths["kmt"], "j_kmt.bin")):
        with open(ours, "rb") as a, open(tmp_path / theirs, "rb") as b:
            assert a.read() == b.read(), theirs
    assert os.path.getsize(paths["grid"]) == 7 * nx * ny * 8


PAIRS = [("T", "U"), ("U", "T"), ("T", "E"), ("E", "T"), ("T", "N"),
         ("N", "T"), ("E", "U"), ("N", "U"), ("E", "N"), ("N", "E"),
         ("U", "E"), ("U", "N")]


@pytest.fixture(scope="module")
def grids16():
    """A masked 16x16 rectgrid (land corners) in both packages."""
    jg = jgrid.rectgrid(16, 16, kmt_type="default", dtype=jnp.float64)
    tg = tgrid.rectgrid(16, 16, kmt_type="default", dtype=torch.float64,
                        device="cpu")
    return jg, tg


@pytest.mark.parametrize("kind", ["S", "A", "F"])
@pytest.mark.parametrize("src,dst", PAIRS)
def test_grid_average_X2Y_matches_jax(grids16, src, dst, kind):
    jg, tg = grids16
    w = np.random.default_rng(7).random((16, 16))
    ref = np.asarray(jgrid.grid_average_X2Y(kind, jnp.asarray(w), src, dst,
                                            jg))
    got = tgrid.grid_average_X2Y(kind, torch.as_tensor(w), src, dst,
                                 tg).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-15)
