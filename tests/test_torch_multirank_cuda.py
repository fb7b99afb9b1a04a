"""Runs across ranks on the card: two ranks (spawned processes joined by
gloo) share one CUDA device. Every test needs a CUDA device: marked
`cuda`, they skip on a machine without one. On the GPU machine run them
with

    python -m pytest --noconftest tests/test_torch_multirank_cuda.py -q

- Each rank's padded tile runs its subcycles through K1, and the wide
  solve equals K1 on the whole grid bit for bit, on 1x2 and 2x1 ranks;
  on a tripole grid (which K1 alone refuses) it equals the plain
  `evp_solve` bit for bit.
- gloo carries CPU tensors only: each halo message of a CUDA tile, and
  the final all-gather of the interiors, is staged through host memory,
  and the bytes staged are counted exactly.
- One process without a mesh runs evp_algorithm='wide_halo' through K1 on
  the whole grid, bit for bit as 'fused_pallas'.
- With the state sharded on 1x2 and 2x1 ranks, two steps of
  gx1pop_step(48, 40) through K1 + K3 and (remap_kernel='auto') K1 + K2
  equal two steps of one process bit for bit, with K1 and K3 (or K2)
  launched on every rank's tile.
- EAP (kdyn=2) sharded on 1x2 ranks: two steps through K2 equal two steps
  of one process bit for bit (on the card every element of `atan2` takes
  the same path), K2 once per step on each rank.
- The VP operator on each rank's padded tile equals the whole-grid
  operator bit for bit on the card (f32), and one dynpicard step (VP
  counts cut) on 1x2 ranks launches K2 once on each rank and stays within
  the decomp oracle of one process.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cice_tpu_torch.core.grid import rectgrid  # noqa: E402
from cice_tpu_torch.core.halo import BC  # noqa: E402
from cice_tpu_torch.config import Config  # noqa: E402
from cice_tpu_torch.dynamics.evp import evp_solve  # noqa: E402
from cice_tpu_torch.kernels import _build  # noqa: E402
from cice_tpu_torch.kernels import evp as kevp  # noqa: E402
from cice_tpu_torch.measure import evp_problem  # noqa: E402
from cice_tpu_torch.parallel import spawn  # noqa: E402

pytestmark = pytest.mark.cuda

NX, NY, NDTE, K = 96, 64, 20, 8


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode; the wide "
                    "solve is tested against JAX on the CPU)")
    _build.build()                    # once, before the ranks start
    return torch.device("cuda")


def _problem(cuda, ns):
    cfg = Config().with_overrides(**{"grid.nx_global": NX,
                                     "grid.ny_global": NY})
    grid = rectgrid(NX, NY, kmt_type="default", bc=BC("cyclic", ns),
                    device=cuda)
    return evp_problem(grid, cfg.dynamics, cfg.setup.dt, cuda, ndte=NDTE)


@pytest.fixture(scope="module")
def runs(cuda, tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("ranks"))
    args, kw = _problem(cuda, "open")
    targs, tkw = _problem(cuda, "tripole")
    refs = {"open": kevp.evp_solve_fused(*args, **kw),
            "tripole": evp_solve(*targs, **tkw)}
    paths = {"open": spawn.save(spawn.b_problem_to_numpy(*args, **kw),
                                os.path.join(wd, "open.pkl")),
             "tripole": spawn.save(spawn.b_problem_to_numpy(*targs, **tkw),
                                   os.path.join(wd, "tripole.pkl"))}
    cases = [("open", (1, 2)), ("open", (2, 1)), ("tripole", (1, 2))]
    jobs = [("evp_b", dict(problem=paths[ns], shape=shape, k_fuse=K,
                           device="cuda"), 2) for ns, shape in cases]
    res = spawn.launch(jobs, 2, wd, timeout=600.0)
    return {(ns, shape): (r, refs[ns]) for (ns, shape), r in zip(cases, res)}


@pytest.mark.parametrize("case", [("open", (1, 2)), ("open", (2, 1)),
                                  ("tripole", (1, 2))],
                         ids=["1x2", "2x1", "tripole_1x2"])
def test_tiles_through_k1_equal_the_whole_grid(runs, case):
    r, ref = runs[case]
    assert len({x["digest"] for x in r}) == 1
    for a, b in zip(r[0]["out"], ref):
        np.testing.assert_array_equal(a, b.cpu().numpy())
    chunks = -(-NDTE // K)
    assert [x["stats"]["k1_launches"] for x in r] == [chunks, chunks]


def test_the_exchange_stages_through_the_host(runs):
    """On a 1x2 mesh with a cyclic x axis each rank sends and receives two
    column slabs per stage (one per side; the rows stage sends nothing on
    an open y axis): 26 constant planes once, 14 state planes per chunk,
    H = K columns of the padded height, 4 bytes a value, both ways. The
    all-gather stages the rank's 14-plane tile out and both tiles back."""
    r, _ = runs[("open", (1, 2))]
    H = K
    h = NY + 2 * H
    chunks = -(-NDTE // K)
    tile = 14 * NY * (NX // 2) * 4
    want = 2 * 2 * H * h * 4 * (26 + 14 * chunks) + tile + 2 * tile
    for x in r:
        st = x["stats"]
        assert st["staged_bytes"] == want
        assert st["staged_seconds"] > 0 and st["wire_seconds"] > 0
        assert st["wait_seconds"] > 0
        assert st["staged_seconds"] + st["wire_seconds"] + \
            st["wait_seconds"] < st["seconds"]


def test_one_process_wide_halo_step_launches_k1(cuda):
    """Without a mesh 'wide_halo' is the one-program solve through K1 on
    the whole grid: launched, and equal to 'fused_pallas' bit for bit."""
    from cice_tpu_torch.config import gx1pop_step
    from cice_tpu_torch.model.driver import Model
    from cice_tpu_torch.model.state import state_leaves
    base = gx1pop_step(48, 40)
    out = {}
    for algo in ("fused_pallas", "wide_halo"):
        m = Model(base.with_overrides(**{"dynamics.evp_algorithm": algo}),
                  device="cuda")
        n0 = kevp.launches
        m.step()
        out[algo] = (kevp.launches - n0, state_leaves(m.state))
    assert out["wide_halo"][0] >= 1
    assert out["wide_halo"][0] == out["fused_pallas"][0]
    for a, b in zip(out["wide_halo"][1], out["fused_pallas"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kernel", ["fused_pallas", "auto"])
def test_sharded_steps_launch_on_every_tile(cuda, kernel, tmp_path):
    from cice_tpu_torch.config import gx1pop_step
    from cice_tpu_torch.model.driver import Model
    from cice_tpu_torch.model.state import state_leaves
    cfg = gx1pop_step(48, 40, remap_kernel=kernel)
    one = Model(cfg, device="cuda")
    one.step()
    one.step()
    ref = [x.cpu().numpy() for x in state_leaves(one.state)]
    shapes = [(1, 2), (2, 1)]
    res = spawn.launch([("sharded_steps", dict(cfg=cfg, nsteps=2,
                                               shape=shape, device="cuda"),
                         2) for shape in shapes], 2, str(tmp_path),
                       timeout=600.0)
    flux = "k2_launches" if kernel == "auto" else "k3_launches"
    for r in res:
        assert len({x["digest"] for x in r}) == 1
        for a, b in zip(r[0]["out"], ref):
            np.testing.assert_array_equal(a, b)
        for x in r:
            st = x["stats"]
            assert st["k1_launches"] >= 2 and st[flux] >= 2, st
            assert st["staged_bytes"] > 0 and st["exchanges"] > 0


def _eap_vp_cfg(kdyn):
    from cice_tpu_torch.config import gx1pop_step
    over = {"dynamics.kdyn": kdyn}
    if kdyn == 3:
        over.update({"dynamics.maxits_nonlin": 3, "dynamics.dim_fgmres": 10,
                     "dynamics.maxits_fgmres": 10, "dynamics.dim_pgmres": 3,
                     "dynamics.maxits_pgmres": 3})
    return gx1pop_step(48, 40, remap_kernel="auto").with_overrides(**over)


def _one_process(cfg, nsteps):
    from cice_tpu_torch.model.driver import Model
    from cice_tpu_torch.model.state import state_leaves
    one = Model(cfg, device="cuda")
    for _ in range(nsteps):
        one.step()
    return [x.cpu().numpy() for x in state_leaves(one.state)]


def test_sharded_eap_steps_equal_one_process_on_the_card(cuda, tmp_path):
    cfg = _eap_vp_cfg(2)
    ref = _one_process(cfg, 2)
    (r,) = spawn.launch([("sharded_steps", dict(cfg=cfg, nsteps=2,
                                                shape=(1, 2),
                                                device="cuda"), 2)], 2,
                        str(tmp_path), timeout=600.0)
    assert len({x["digest"] for x in r}) == 1
    for a, b in zip(r[0]["out"], ref):
        np.testing.assert_array_equal(a, b)
    assert [x["stats"]["k2_launches"] for x in r] == [2, 2]


def test_padded_vp_operator_equals_the_whole_grid_on_the_card(cuda,
                                                              tmp_path):
    import test_torch_rank_jobs as rj
    problem = rj.vp_problem(_eap_vp_cfg(3), str(tmp_path / "vp.pkl"),
                            device="cuda")
    ref = rj.vp_operator_whole(problem, "cuda")
    (r,) = spawn.launch([(rj.vp_operator, dict(problem=problem, shape=(1, 2),
                                               device="cuda"), 2)], 2,
                        str(tmp_path), timeout=600.0)
    assert len({x["digest"] for x in r}) == 1
    for a, b in zip(r[0]["out"][:3], ref[:3]):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert float(np.abs(ref[0]).max()) > 0


def test_sharded_vp_step_launches_k2_on_every_tile(cuda, tmp_path):
    cfg = _eap_vp_cfg(3)
    ref = _one_process(cfg, 1)
    (r,) = spawn.launch([("sharded_steps", dict(cfg=cfg, nsteps=1,
                                                shape=(1, 2),
                                                device="cuda"), 2)], 2,
                        str(tmp_path), timeout=600.0)
    assert len({x["digest"] for x in r}) == 1
    assert [x["stats"]["k2_launches"] for x in r] == [1, 1]
    assert all(x["stats"]["collectives"] > 0 for x in r)
    for a, b in zip(r[0]["out"], ref):
        if b.dtype.kind != "f":
            np.testing.assert_array_equal(a, b)
        elif b.size:
            assert np.isfinite(a).all()
            scale = float(np.abs(b).max())
            assert float(np.abs(a - b).max()) <= 1e-4 * max(scale, 1e-6)
