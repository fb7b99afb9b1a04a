"""The implicit VP solver of the port with the state sharded across ranks
(cice_tpu_torch.dynamics.vp on a tile grid, through
cice_tpu_torch.model.driver.Model(..., mesh=, shard=True)).

- The operator of one Picard iteration (`vp.linear_system`) on each
  rank's tile padded by `vp.VP_RADIUS` rings equals the whole-grid
  operator bit for bit (A x, b and the diagonal), on 2x4 and 4x2 gloo
  ranks in f32 and f64, with three halo refreshes (the metrics, the
  iterate of the viscosities, one application) and two collectives.
- `grid_sum` and `grid_norm` without a mesh (or on a mesh of one rank)
  are the calls they replaced, bit for bit; with a mesh every rank reads
  the same bits, the ranks' partials added in rank order.
- Two steps of `dynpicard` (MGS and CGS) and of `dynanderson` on the
  gx1pop fixture's 48x40 (tests/test_torch_step.py's configuration, VP
  counts cut as in tests/test_torch_vp.py), on 2x4 and 4x2 ranks in f64:
  each gathered leaf within max(1e-8 of its largest value, 20 times the
  port's own envelope), the envelope being how far two one-process steps
  move when vicen moves by 1 ulp. The Krylov sums add in another order
  across ranks, and the solve is ill-conditioned where the ice is near
  rigid, so the sharded steps are not the one-process bits. Every rank
  gathers the same state.
- The tripole grid (the file-less 32x24 grid of
  tests/test_torch_sharded_step.py) keeps the tile-aware shift path: its
  stencil is the tile itself (radius 0, a message per shift), held as
  above.
- The sharded solve reads nothing on the host (Tensor.item, bool, float,
  int, tolist, numpy counted on every rank inside `implicit_solver`).
- Against the JAX package: two steps of its `model_step` with the state
  and forcing sharded over conftest's 8-device CPU mesh (2x4,
  `cice_tpu.parallel.mesh.shard_state`, f64) hold the port's 2x4 steps
  within tests/test_torch_step.py's tolerances or 20 times the JAX
  package's own envelope (vicen moved by 1 ulp), as tests/test_torch_vp.py
  holds the solve: one JAX compile.

The ranks are spawned processes, one launch for the file.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402

from cice_tpu import constants as jcst  # noqa: E402
from cice_tpu.model.driver import Model as JModel  # noqa: E402
from cice_tpu.model.forcing import get_forcing as jget_forcing  # noqa: E402
from cice_tpu.model.step import model_step as jmodel_step  # noqa: E402
from cice_tpu.parallel.mesh import make_mesh, shard_state  # noqa: E402
from cice_tpu_torch.cli.main import _leaf_names  # noqa: E402
from cice_tpu_torch.config import Config  # noqa: E402
from cice_tpu_torch.dynamics import vp  # noqa: E402
from cice_tpu_torch.model.driver import Model  # noqa: E402
from cice_tpu_torch.model.state import (state_from_leaves,  # noqa: E402
                                        state_leaves)
from cice_tpu_torch.parallel import spawn  # noqa: E402
from cice_tpu_torch.parallel.mesh import Mesh  # noqa: E402

import test_torch_rank_jobs as rj  # noqa: E402
from test_torch_step import FLOORS, RTOL, _cfgs, _tree  # noqa: E402
from test_torch_vp import VP_CUT  # noqa: E402

STEPS = 2
SHAPES = {"2x4": (2, 4), "4x2": (4, 2)}
VP = {"dynamics.kdyn": 3, **VP_CUT}
SETS = {"dynpicard": VP,
        "dynpicard_cgs": {**VP, "dynamics.ortho_type": "cgs"},
        "dynanderson": {**VP, "dynamics.algo_nonlin": "anderson"}}
TRIPOLE = {"grid.grid_format": "tripole", "grid.nx_global": 32,
           "grid.ny_global": 24, "grid.kmt_type": "default",
           "grid.ns_boundary_type": "tripole",
           "forcing.atm_data_type": "box2001",
           "forcing.ocn_data_type": "box2001", "dynamics.ndte": 40,
           "dtype": "float64", **VP}
RUNS = [(case, sh) for case in SETS for sh in SHAPES] + [("tripole", "2x4")]
OPERATOR = [(dt, sh) for dt in ("float32", "float64") for sh in SHAPES]


def _cfg(case: str):
    if case == "tripole":
        return Config().with_overrides(**TRIPOLE)
    return _cfgs("float64", **SETS[case])[0]


def _one(cfg, factor=None):
    """The state leaves after STEPS steps of one process (vicen x factor
    at the start)."""
    m = Model(cfg, device="cpu")
    if factor is not None:
        m.state = m.state.replace(vicen=m.state.vicen * factor)
    for _ in range(STEPS):
        m.step()
    return m, [x.numpy() for x in state_leaves(m.state)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every sharded case in one launch, beside the one-process leaves
    and envelopes of each case."""
    wd = str(tmp_path_factory.mktemp("ranks"))
    problems = {dt: rj.vp_problem(_cfgs(dt, **VP)[0],
                                  os.path.join(wd, f"vp_{dt}.pkl"))
                for dt in ("float32", "float64")}
    jobs = [("sharded_steps", dict(cfg=_cfg(case), nsteps=STEPS,
                                   shape=SHAPES[sh]), 8)
            for case, sh in RUNS]
    jobs += [(rj.vp_operator, dict(problem=problems[dt], shape=SHAPES[sh]),
              8) for dt, sh in OPERATOR]
    reads_cfg = _cfg("dynanderson").with_overrides(
        **{"dynamics.reltol_fgmres": 0.1})
    jobs.append((rj.vp_host_reads, dict(cfg=reads_cfg, shape=(2, 4)), 8))
    res = spawn.launch(jobs, 8, wd, timeout=600.0)
    n = len(RUNS)
    out = dict(steps=dict(zip(RUNS, res[:n])),
               operator=dict(zip(OPERATOR, res[n:n + len(OPERATOR)])),
               reads=res[-1], problems=problems, one={}, env={})
    for case in list(SETS) + ["tripole"]:
        cfg = _cfg(case)
        m, out["one"][case] = _one(cfg)
        eps = float(np.finfo(out["one"][case][0].dtype).eps)
        out["env"][case] = _one(cfg, 1.0 + eps)[1]
        if case == "dynpicard":
            out["template"] = m.state
            out["names"] = _leaf_names(m.state)
    return out


def _within_envelope(got, ref, env, what):
    """Each leaf within max(RTOL of its largest value, 20 x envelope);
    ints and bools equal."""
    assert len(got) == len(ref) == len(env)
    for i, (a, b, e) in enumerate(zip(got, ref, env)):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
        if b.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: leaf {i}")
            continue
        if not b.size:
            continue
        scale = float(np.abs(b).max())
        envelope = float(np.abs(e - b).max())
        err = float(np.abs(a - b).max())
        assert err <= max(RTOL["float64"] * scale, 20.0 * envelope), \
            (what, i, err, scale, envelope)


@pytest.mark.parametrize("dtype,shape", OPERATOR,
                         ids=[f"{d}-{s}" for d, s in OPERATOR])
def test_padded_tile_operator_equals_the_whole_grid(runs, dtype, shape):
    r = runs["operator"][(dtype, shape)]
    assert len({x["digest"] for x in r}) == 1
    ref = rj.vp_operator_whole(runs["problems"][dtype])
    got = r[0]["out"]
    for name, a, b in zip(("A x", "b", "diag"), got[:3], ref[:3]):
        assert a.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert float(np.abs(ref[0]).max()) > 0
    assert float(np.abs(ref[1]).max()) > 0
    for x in r:
        st = x["stats"]
        assert st["radius"] == vp.VP_RADIUS == 1
        # two-stage refreshes: the metrics, (u, v), one application
        assert (st["exchanges"], st["collectives"]) == (6, 2)
    # x . A x and |A x|: the ranks' partials in rank order; the norm
    # agrees with the whole grid's to rounding
    parts = got[5]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    assert got[3] == total
    np.testing.assert_allclose(got[4], ref[4], rtol=1e-5)


def test_reductions_without_a_mesh_are_the_plain_calls():
    rng = np.random.default_rng(4)
    for dtype in (np.float32, np.float64):
        x = torch.as_tensor(rng.standard_normal((2, 24, 10)).astype(dtype))
        y = torch.as_tensor(rng.standard_normal((2, 24, 10)).astype(dtype))
        for mesh in (None, Mesh()):
            local = torch.sum(x * y)
            assert torch.equal(vp.grid_sum(local, mesh), local)
            assert torch.equal(vp.grid_norm(x, mesh),
                               torch.linalg.vector_norm(x))
            hs = torch.tensordot(torch.stack([x, y]), x, dims=3)
            assert torch.equal(vp.grid_sum(hs, mesh), hs)


def test_sharded_operator_reads_the_same_bits_on_every_rank(runs):
    for (dtype, shape), r in runs["operator"].items():
        assert len({x["digest"] for x in r}) == 1, (dtype, shape)
        assert len(r[0]["out"][5]) == 8


@pytest.mark.parametrize("case,shape", RUNS,
                         ids=[f"{c}-{s}" for c, s in RUNS])
def test_sharded_vp_steps_within_the_envelope_of_one_process(runs, case,
                                                             shape):
    r = runs["steps"][(case, shape)]
    assert len({x["digest"] for x in r}) == 1        # every rank gathers it
    _within_envelope(r[0]["out"], runs["one"][case], runs["env"][case],
                     f"{case} {shape}")
    st = [x["stats"] for x in r]
    assert [x["istep"] for x in st] == [STEPS] * 8
    assert all(x["collectives"] > 0 for x in st)
    # the ice moves
    uvel = runs["one"][case][runs["names"].index("uvel")]
    assert float(np.abs(uvel).max()) > 1e-3


def test_tripole_keeps_the_tile_aware_shift_path(runs):
    """On the tripole grid the stencil is the tile itself: no padding, a
    message per shift, so its sharded VP steps make many more messages
    than the padded path on the same number of iterations."""
    cfg = _cfg("tripole")
    m = Model(cfg, device="cpu", mesh=Mesh(), shard=True)
    assert vp.Stencil(m.grid, m.grid.tarea, m.grid.tarea).radius == 0
    tri = runs["steps"][("tripole", "2x4")][0]["stats"]
    pad = runs["steps"][("dynpicard", "2x4")][0]["stats"]
    assert tri["exchanges"] > 3 * pad["exchanges"]


def test_the_sharded_solve_reads_nothing_on_the_host(runs):
    for reads, finite, umax in runs["reads"]:
        assert reads == []
        assert finite and umax > 0.0


def test_sharded_vp_steps_match_jax_on_eight_devices(runs, devices8):
    """The port's dynpicard steps on 2x4 ranks against the JAX package's
    model_step with the state and forcing sharded on its 2x4 device mesh
    (f64), each leaf within tests/test_torch_step.py's rtol and floors or
    20 times the JAX package's own envelope (vicen moved by 1 ulp)."""
    _, jcfg = _cfgs("float64", **VP)
    dt = jcfg.setup.dt
    mesh = make_mesh(shape=(2, 4))
    m = JModel(jcfg)
    fn = jax.jit(lambda s, fc: jmodel_step(m.static, m.grid, s, fc, dt))

    def run(factor):
        st = m.state.replace(vicen=m.state.vicen * factor)
        st, fc = shard_state(mesh, st), m.forcing
        for step in range(STEPS):
            t = step * dt
            fc = shard_state(mesh, jget_forcing(
                jcfg, m.grid, t, 1.0 + t / jcst.secday, st.aice, fc))
            st, _ = fn(st, fc)
        assert len(st.aicen.sharding.device_set) == 8
        return _tree(st)

    ref = run(1.0)
    env = run(1.0 + np.finfo(np.float64).eps)
    got = _tree(state_from_leaves(runs["template"], [
        torch.as_tensor(a) for a in
        runs["steps"][("dynpicard", "2x4")][0]["out"]]))
    assert set(ref) <= set(got)
    for k in ref:
        a, b, e = (np.asarray(t[k]) for t in (got, ref, env))
        assert a.shape == b.shape, k
        if b.dtype == np.bool_:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        leaf = k.split(".")[-1]
        atol = max(RTOL["float64"] * float(np.abs(b).max()),
                   FLOORS.get(leaf, (0.0, 0.0))[0],
                   20.0 * float(np.abs(e - b).max()))
        np.testing.assert_allclose(a, b, rtol=RTOL["float64"], atol=atol,
                                   err_msg=k)
    assert float(np.abs(ref["uvel"]).max()) > 1e-3
