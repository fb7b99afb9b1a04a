"""EAP dynamics of the port with the state sharded across ranks
(`parallel.evp_wide.eap_solve_wide`: the plain `_subcycle` on each rank's
tile padded by k rings, k subcycles per halo exchange, through
cice_tpu_torch.model.driver.Model(..., mesh=, shard=True)).

Two steps of `kdyn=2` on the gx1pop fixture's 48x40 (tests/
test_torch_step.py's configuration) on 2x4 and 4x2 gloo ranks, of the
`alt03` (4x2) and `boxadv` (2x4, cyclic in both directions) option sets,
and of the file-less 32x24 tripole grid of tests/test_torch_sharded_step.py
(2x4: the structure tensor folds with the stresses), all in f64. Each
gathered leaf is held against two steps of one process within max(1e-8
of its largest value, 20 times the port's own envelope: how far the
one-process steps move when vicen moves by 1 ulp), not bit for bit: EAP's
yield-table lookup truncates ratios of float32 `atan2`s to indices, and on
the CPU `atan2` rounds the tail of a vector loop otherwise than its body,
so a tile can pick another table entry than the whole grid. Every rank
gathers the same state.

Against the JAX package, two steps (ndte 10) of its `model_step`, f64:
- run op by op (`jax.disable_jit()`, as tests/test_torch_eap.py runs its
  reference), the port's 2x4 steps within tests/test_torch_step.py's
  tolerances and floors. Op by op there is no sharding (GSPMD partitions
  compiled programs; eager operations return arrays on one device), so
  this reference runs on one device;
- with the state and forcing sharded over conftest's 8-device CPU mesh
  (2x4, `cice_tpu.parallel.mesh.shard_state`), jitted: one JAX compile.
  Jitted, XLA contracts EAP's float32 table sums (float32 whatever the
  state's dtype: the yield tables are float32) into fused multiply-adds,
  one float32 ulp off the written sums (the stresses move by 6e-8 to
  1.3e-7 of their largest values, the velocities by 1.4e-8), so each leaf
  is held within 10 float32 ulps of its largest value beside the step
  tolerances.

The ranks are spawned processes, one launch for the file.
"""

import contextlib

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
from cice_tpu_torch.cli.main import OPTION_SETS  # noqa: E402
from cice_tpu_torch.config import Config  # noqa: E402
from cice_tpu_torch.model.driver import Model  # noqa: E402
from cice_tpu_torch.model.state import state_from_leaves  # noqa: E402
from cice_tpu_torch.parallel import spawn  # noqa: E402

from test_torch_sharded_vp import _one, _within_envelope  # noqa: E402
from test_torch_step import (FLOORS, RTOL, _cfgs, _compare,  # noqa: E402
                             _tree)

STEPS = 2
EAP = {"dynamics.kdyn": 2}
TRIPOLE = {"grid.grid_format": "tripole", "grid.nx_global": 32,
           "grid.ny_global": 24, "grid.kmt_type": "default",
           "grid.ns_boundary_type": "tripole",
           "forcing.atm_data_type": "box2001",
           "forcing.ocn_data_type": "box2001", "dynamics.ndte": 40,
           "dtype": "float64", **EAP}
#: the JAX comparisons' subcycles (op by op, JAX's step is slow)
JAX_NDTE = 10
RUNS = [("eap", "2x4"), ("eap", "4x2"), ("alt03", "4x2"), ("boxadv", "2x4"),
        ("tripole", "2x4")]
SHAPES = {"2x4": (2, 4), "4x2": (4, 2)}


def _cfg(case: str):
    if case == "tripole":
        return Config().with_overrides(**TRIPOLE)
    if case == "jax":
        return _cfgs("float64", **EAP, **{"dynamics.ndte": JAX_NDTE})[0]
    over = EAP if case == "eap" else OPTION_SETS[case]
    return _cfgs("float64", **over)[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every sharded case in one launch, beside the one-process leaves
    and envelopes of each case."""
    wd = str(tmp_path_factory.mktemp("ranks"))
    cases = RUNS + [("jax", "2x4")]
    res = spawn.launch([("sharded_steps", dict(cfg=_cfg(case), nsteps=STEPS,
                                               shape=SHAPES[sh]), 8)
                        for case, sh in cases], 8, wd, timeout=600.0)
    out = dict(steps=dict(zip(cases, res)), one={}, env={})
    for case in {c for c, _ in RUNS}:
        cfg = _cfg(case)
        m, out["one"][case] = _one(cfg)
        eps = float(np.finfo(out["one"][case][0].dtype).eps)
        out["env"][case] = _one(cfg, 1.0 + eps)[1]
        out.setdefault("a11", {})[case] = float(
            (m.state.a11 - 0.5).abs().max())
    out["template"] = Model(_cfg("jax"), device="cpu").state
    return out


@pytest.mark.parametrize("case,shape", RUNS,
                         ids=[f"{c}-{s}" for c, s in RUNS])
def test_sharded_eap_steps_within_the_envelope_of_one_process(runs, case,
                                                              shape):
    r = runs["steps"][(case, shape)]
    assert len({x["digest"] for x in r}) == 1        # every rank gathers it
    _within_envelope(r[0]["out"], runs["one"][case], runs["env"][case],
                     f"{case} {shape}")
    st = [x["stats"] for x in r]
    assert [x["istep"] for x in st] == [STEPS] * 8
    assert all(x["exchanges"] > 0 for x in st)
    assert runs["a11"][case] > 0.0          # the structure tensor evolves


def _jax_steps(sharded: bool):
    """Two JAX model_steps at ndte JAX_NDTE: jitted with the state and
    forcing sharded on the 2x4 device mesh, else op by op on one
    device."""
    _, jcfg = _cfgs("float64", **EAP, **{"dynamics.ndte": JAX_NDTE})
    m = JModel(jcfg)
    dt = jcfg.setup.dt
    mesh = make_mesh(shape=(2, 4))
    put = (lambda x: shard_state(mesh, x)) if sharded else (lambda x: x)
    step_fn = jax.jit(lambda s, fc: jmodel_step(m.static, m.grid, s, fc,
                                                dt)) if sharded else \
        (lambda s, fc: jmodel_step(m.static, m.grid, s, fc, dt))
    with contextlib.nullcontext() if sharded else jax.disable_jit():
        st, fc = put(m.state), m.forcing
        for step in range(STEPS):
            t = step * dt
            fc = put(jget_forcing(jcfg, m.grid, t, 1.0 + t / jcst.secday,
                                  st.aice, fc))
            st, _ = step_fn(st, fc)
    assert float(np.abs(np.asarray(st.uvel)).max()) > 1e-3
    assert float(np.abs(np.asarray(st.a12)).max()) > 0.0
    return st


def _port_2x4(runs):
    return _tree(state_from_leaves(runs["template"], [
        torch.as_tensor(a) for a in runs["steps"][("jax", "2x4")][0]["out"]]))


def test_sharded_eap_steps_match_jax_op_by_op(runs):
    """The port's EAP steps on 2x4 ranks against the JAX package's
    model_step op by op."""
    _compare(_port_2x4(runs), _tree(_jax_steps(False)),
             "sharded 2x4 vs JAX op by op", "float64")


def test_sharded_eap_steps_match_jax_on_eight_devices(runs, devices8):
    """The port's EAP steps on 2x4 ranks against the JAX package's jitted
    model_step with the state and forcing sharded on its 2x4 device mesh:
    each leaf within the step tolerances or 10 float32 ulps of its largest
    value (the FMA-contracted float32 table sums)."""
    st = _jax_steps(True)
    assert len(st.aicen.sharding.device_set) == 8
    got, ref = _port_2x4(runs), _tree(st)
    assert set(ref) <= set(got)
    ulp32 = float(np.finfo(np.float32).eps)
    for k in ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if b.dtype == np.bool_:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        scale = float(np.abs(b).max()) if b.size else 0.0
        atol = max(RTOL["float64"] * scale, 10.0 * ulp32 * scale,
                   FLOORS.get(k.split(".")[-1], (0.0, 0.0))[0])
        np.testing.assert_allclose(a, b, rtol=RTOL["float64"], atol=atol,
                                   err_msg=k)
