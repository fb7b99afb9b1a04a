"""The port's decomposition utilities (cice_tpu_torch.parallel.decomp, its
own copy of cice_tpu/parallel/decomp.py) against tests/test_decomp.py's
property checks (ice_spacecurve: every block once, unit steps;
ice_distribution: covering, balance, land-block elimination) and, for
every function, equal arrays against the JAX package's."""

import numpy as np
import pytest

pytest.importorskip("torch")

from cice_tpu.parallel import decomp as jdecomp  # noqa: E402
from cice_tpu_torch.parallel.decomp import (  # noqa: E402
    auto_decomp, create_distribution, distribution_stats, gilbert2d,
    hilbert2d, spacecurve, spacecurve_device_order, work_per_block)

SIZES = [(1, 1), (2, 2), (4, 4), (8, 8), (3, 3), (5, 5), (6, 9), (7, 11),
         (12, 20), (40, 48), (1, 7), (9, 1), (13, 2)]
METHODS = ["cartesian", "roundrobin", "sectcart", "sectrobin",
           "spiralcenter", "rake", "spacecurve", "wghtfile"]


@pytest.mark.parametrize("w,h", SIZES)
def test_gilbert_is_unit_step_permutation(w, h):
    pts = gilbert2d(w, h)
    np.testing.assert_array_equal(pts, jdecomp.gilbert2d(w, h))
    assert pts.shape == (w * h, 2)
    lin = pts[:, 1] * w + pts[:, 0]
    assert len(np.unique(lin)) == w * h
    assert pts[:, 0].min() == 0 and pts[:, 0].max() == w - 1
    assert pts[:, 1].min() == 0 and pts[:, 1].max() == h - 1
    # consecutive cells are 4-neighbours; odd-long x even-short rectangles
    # admit exactly one diagonal step (bipartite parity)
    d = np.abs(np.diff(pts, axis=0)).sum(axis=1)
    diag = (np.abs(np.diff(pts, axis=0)) == 1).all(axis=1)
    if (max(w, h) % 2 == 1) and (min(w, h) % 2 == 0) and min(w, h) > 1:
        assert ((d == 1) | diag).all() and diag.sum() <= 1
    else:
        assert (d == 1).all()


def test_hilbert_special_case():
    pts = hilbert2d(3)
    np.testing.assert_array_equal(pts, jdecomp.hilbert2d(3))
    assert pts.shape == (64, 2)
    assert (np.abs(np.diff(pts, axis=0)).sum(axis=1) == 1).all()


def test_spacecurve_rank_grid():
    rank = spacecurve(6, 5)
    np.testing.assert_array_equal(rank, jdecomp.spacecurve(6, 5))
    assert rank.shape == (5, 6)
    assert sorted(rank.ravel().tolist()) == list(range(30))


@pytest.mark.parametrize("method", METHODS)
def test_distribution_covers_and_balances(method):
    nbx, nby, nprocs = 8, 6, 4
    work = 0.5 + np.random.RandomState(0).rand(nby, nbx)
    dist = create_distribution(nbx, nby, nprocs, method, work=work)
    np.testing.assert_array_equal(
        dist, jdecomp.create_distribution(nbx, nby, nprocs, method,
                                          work=work))
    assert dist.shape == (nby, nbx)
    assert dist.min() >= 0 and dist.max() < nprocs
    assert len(np.unique(dist)) == nprocs
    st = distribution_stats(dist, work)
    assert st == jdecomp.distribution_stats(dist, work)
    assert st["active_blocks"] == nbx * nby
    if method in ("rake", "wghtfile", "spacecurve", "spiralcenter"):
        assert st["imbalance"] < 0.6


def test_land_block_elimination():
    kmt = np.ones((40, 60))
    kmt[:20, :30] = 0.0          # the SW quadrant is land
    work = work_per_block(6, 4, "block", kmt=kmt)
    np.testing.assert_array_equal(
        work, jdecomp.work_per_block(6, 4, "block", kmt=kmt))
    dist = create_distribution(6, 4, 3, "spacecurve", work=work)
    assert (dist[:2, :3] == -1).all()
    assert (dist[2:, :] >= 0).all()
    assert distribution_stats(dist, work)["eliminated_blocks"] == 6


def test_work_weightings():
    lat = np.linspace(-80, 80, 32)[:, None] * np.ones((1, 16))
    w = work_per_block(4, 4, "latitude", lat_t=lat)
    np.testing.assert_array_equal(
        w, jdecomp.work_per_block(4, 4, "latitude", lat_t=lat))
    assert w.shape == (4, 4) and w[0].mean() > w[1].mean()
    f = np.arange(64.0).reshape(8, 8)
    np.testing.assert_array_equal(
        work_per_block(4, 4, "file", wght=f),
        jdecomp.work_per_block(4, 4, "file", wght=f))
    for kind, kw in (("latitude", {}), ("file", {}), ("bogus", {})):
        with pytest.raises(ValueError):
            work_per_block(4, 4, kind, **kw)
    with pytest.raises(ValueError, match="unknown distribution"):
        create_distribution(4, 4, 2, "bogus")


@pytest.mark.parametrize("grid,n", [((320, 384), 8), ((256, 256), 1),
                                    ((360, 240), 8), ((100, 116), 6),
                                    ((320, 384), 4), ((48, 40), 2)])
def test_auto_decomp(grid, n):
    (py, px), (ty, tx) = auto_decomp(*grid, n)
    assert ((py, px), (ty, tx)) == jdecomp.auto_decomp(*grid, n)
    assert py * px == n
    assert ty * py >= grid[1] and tx * px >= grid[0]


@pytest.mark.parametrize("py,px", [(4, 4), (2, 4), (4, 2), (1, 8), (3, 5)])
def test_spacecurve_device_order(py, px):
    order = spacecurve_device_order(py, px)
    np.testing.assert_array_equal(order,
                                  jdecomp.spacecurve_device_order(py, px))
    assert sorted(order.tolist()) == list(range(py * px))
