"""The tile-aware halo of the port (cice_tpu_torch.core.halo with a
`TileBC`, cice_tpu_torch.parallel.mesh): on 1x1, 1x2, 2x4 and 4x2 ranks,
and on 2x4 and 4x2 ranks with unequal tiles, `shift` for every (dj, di) in
[-2, 2]^2, `neighbors4`, `extrapolate_edges` and `apply_closed_mask` on a
rank's tile equal that rank's tile of the global result exactly
(torch.equal), for the BCs cyclic/open/closed in x and open/closed/cyclic/
tripole/tripoleT in y and, at a tripole seam, every field location and
type. The ranks are spawned processes joined by gloo, one launch for the
file. Unequal tiles shard and gather back; a rank that leaves out a shift
its peer makes fails the run within the group's timeout.
"""

import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

from cice_tpu_torch.parallel import spawn  # noqa: E402

import test_torch_rank_jobs as rank_jobs  # noqa: E402

# (mesh, global grid, ranks): 24x16 splits evenly; 23x18 gives tiles of
# 12 and 11 rows and 5, 5, 5 and 3 columns on 2x4, 6 and 5 rows on 4x2
MESHES = {"1x1": ((1, 1), (24, 16), 1), "1x2": ((1, 2), (24, 16), 2),
          "2x4": ((2, 4), (24, 16), 8), "4x2": ((4, 2), (24, 16), 8),
          "2x4_unequal": ((2, 4), (23, 18), 8),
          "4x2_unequal": ((4, 2), (23, 18), 8)}
FUNCTIONS = ("shift", "neighbors4", "extrapolate_edges", "apply_closed_mask")
# cases per rank: 3 x 3 non-tripole BCs + 3 x 2 tripole BCs x 12 kinds
CASES = {"shift": 25 * (9 + 6 * 12), "neighbors4": 9 + 6 * 12,
         "extrapolate_edges": 15, "apply_closed_mask": 30}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs = [(rank_jobs.halo_checks, dict(shape=shape, grid_shape=grid), n)
            for shape, grid, n in MESHES.values()]
    jobs += [(rank_jobs.gather_unequal, dict(shape=(2, 4),
                                             grid_shape=(23, 18)), 8)]
    res = spawn.launch(jobs, 8, str(tmp_path_factory.mktemp("ranks")),
                       timeout=300.0)
    return dict(zip(list(MESHES) + ["gather"], res))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_tile_equals_the_tile_of_the_global_result(runs, mesh, fn):
    ranks = [r for r in runs[mesh] if r is not None]
    assert len(ranks) == MESHES[mesh][2]
    for r in ranks:
        n, bad = r[fn]
        assert n == CASES[fn] and bad == [], bad[:10]


def test_unequal_tiles_shard_and_gather_back(runs):
    r = runs["gather"]
    assert [x["tile"][1:] for x in r] == [(12, 5)] * 3 + [(12, 3)] + \
        [(11, 5)] * 3 + [(11, 3)]
    assert all(x["equal"] and x["scalar"] == 2.0 for x in r)


def test_a_rank_that_skips_a_shift_fails_within_the_timeout(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1"):
        spawn.launch([(rank_jobs.skip_a_shift, {}, 2)], 2, str(tmp_path),
                     timeout=120.0, group_timeout=5.0)
    assert time.monotonic() - t0 < 60.0
