"""The whole coupled step of the port with the state sharded across ranks
(cice_tpu_torch.model.driver.Model(..., mesh=, shard=True)).

Two steps of `gx1pop_step(nx=40, ny=48)` (ndte=120) on 2x4 and on 4x2
gloo ranks, with remap_kernel 'xla' and 'fused_pallas' (the plain versions
of K1 and K3 on the CPU: the EVP as the wide-halo solve on the tiles), in
f64 and f32, and two steps of a file-less tripole grid (the fold through
the tile-aware shift and the wide solve's exchange) and of the upwind
transport, each gathered state leaf equal to two steps of one process of
the port bit for bit. So, on one of the two layouts each (f32, ndte=30),
are the C grid (the plain loop and the wide-halo solve on the tiles), the
CD grid, van Leer and remap_q, and (f64) the column physics composite
mushy,dedd,snwgrain,fsd12,fdrag,pondtopo, bgcskl, bdyrestore and
prescribed. Every rank gathers the same state. Across ranks the
history file and the cdf1 restart are the bytes one process writes, and a
'pio' restart written tile by tile resumes on one process bit for bit.

Against the JAX package: two steps of its `model_step` with the state and
forcing sharded over conftest's 8-device CPU mesh (2x4,
`cice_tpu.parallel.mesh.shard_state`; ndte=40, f64) hold the port's
sharded steps within tests/test_torch_step.py's tolerances: one JAX
compile. The port's one-process steps, which its sharded steps equal bit
for bit, are held to the JAX package's one-device `model_step` there.

The ranks are spawned processes, one launch for the file. EAP and VP on
a sharded state are held in tests/test_torch_sharded_eap.py and
tests/test_torch_sharded_vp.py.
"""

import dataclasses
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
from cice_tpu_torch.cli.main import OPTION_SETS  # noqa: E402
from cice_tpu_torch.config import Config, gx1pop_step  # noqa: E402
from cice_tpu_torch.io.pio import read_restart_sharded  # noqa: E402
from cice_tpu_torch.model.driver import Model  # noqa: E402
from cice_tpu_torch.model.state import (state_from_leaves,  # noqa: E402
                                        state_leaves)
from cice_tpu_torch.parallel import spawn  # noqa: E402
from cice_tpu_torch.parallel.mesh import Mesh  # noqa: E402

from test_torch_step import _cfgs, _compare, _tree  # noqa: E402

NX, NY, STEPS = 40, 48, 2
TRIPOLE = {"grid.grid_format": "tripole", "grid.nx_global": 32,
           "grid.ny_global": 24, "grid.kmt_type": "default",
           "grid.ns_boundary_type": "tripole",
           "forcing.atm_data_type": "box2001",
           "forcing.ocn_data_type": "box2001",
           "dynamics.evp_algorithm": "fused_pallas",
           "dynamics.ndte": 40, "dtype": "float64"}


#: the other dynamics and transports, each on one layout
OTHERS = {"gridc": {"grid.grid_ice": "C"},
          "gridc_wide": {"grid.grid_ice": "C",
                         "dynamics.evp_algorithm": "wide_halo"},
          "gridcd": {"grid.grid_ice": "CD"},
          "vanleer": {"dynamics.advection": "vanleer"},
          "remap_q": {"dynamics.advection": "remap_q"}}
#: option sets of the CLI's table, f64 (on the CPU float32 log and exp
#: may round the tail of a vector loop otherwise than its body, which
#: fdrag with fsd12 shows after 2 steps; so does atan2, which EAP reads)
SETS = {"columns": "mushy,dedd,snwgrain,fsd12,fdrag,pondtopo",
        "bgc": "bgcskl", "bdyrestore": "bdyrestore",
        "prescribed": "prescribed"}


def _cfg(case: str):
    if case == "tripole":
        return Config().with_overrides(**TRIPOLE)
    if case == "upwind":
        return gx1pop_step(NX, NY, remap_kernel="xla").with_overrides(**{
            "dynamics.advection": "upwind", "dtype": "float64"})
    if case in OTHERS:
        return gx1pop_step(NX, NY, remap_kernel="xla").with_overrides(**{
            "dtype": "float32", "dynamics.ndte": 30, **OTHERS[case]})
    if case in SETS:
        cfg = gx1pop_step(NX, NY, remap_kernel="xla").with_overrides(**{
            "dtype": "float64", "dynamics.ndte": 30})
        for opt in SETS[case].split(","):
            cfg = cfg.with_overrides(**OPTION_SETS[opt])
        return cfg
    kernel, dtype = case.rsplit("_", 1)
    return gx1pop_step(NX, NY, remap_kernel=kernel).with_overrides(
        dtype={"f64": "float64", "f32": "float32"}[dtype])


SHAPES = {"2x4": (2, 4), "4x2": (4, 2)}
CASES = [f"{k}_{d}" for k in ("xla", "fused_pallas") for d in ("f64", "f32")]
CASES += ["tripole", "upwind"]
RUNS = [(case, sh) for case in CASES for sh in SHAPES]
RUNS += list(zip(OTHERS, ["2x4", "4x2", "2x4", "4x2", "2x4"]))
RUNS += list(zip(SETS, ["4x2", "2x4", "4x2", "2x4"]))
TILES = {("tripole", "2x4"): (12, 8), ("tripole", "4x2"): (6, 16)}


def _io_cfg(root, fmt):
    return _cfg("xla_f64").with_overrides(**{
        "setup.histfreq": ("1", "x", "x", "x", "x"),
        "setup.history_format": "cdf1", "setup.restart_format": fmt,
        "setup.history_dir": os.path.join(root, "history"),
        "setup.restart_dir": os.path.join(root, "restart"),
        "setup.pointer_file": os.path.join(root, "restart", "pointer")})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every sharded case on spawned ranks in one launch: {(case, shape):
    the ranks' results}, beside the one-process leaves of each case."""
    wd = str(tmp_path_factory.mktemp("ranks"))
    jcfg_port = _cfgs("float64")[0]
    jobs, keys = [], []
    for case, sh in RUNS:
        jobs.append(("sharded_steps", dict(cfg=_cfg(case), nsteps=STEPS,
                                           shape=SHAPES[sh]), 8))
        keys.append((case, sh))
    jobs.append(("sharded_steps", dict(cfg=jcfg_port, nsteps=STEPS,
                                       shape=(2, 4)), 8))
    keys.append(("jax_f64", "2x4"))
    io = {"cdf1": _io_cfg(os.path.join(wd, "io8"), "cdf1"),
          "pio": _io_cfg(os.path.join(wd, "pio8"), "pio")}
    for fmt, shape in (("cdf1", (2, 4)), ("pio", (4, 2))):
        jobs.append(("sharded_steps", dict(
            cfg=io[fmt], nsteps=STEPS, shape=shape, write_restart=True,
            history=True), 8))
        keys.append((f"io_{fmt}", f"{shape[0]}x{shape[1]}"))
    res = dict(zip(keys, spawn.launch(jobs, 8, wd, timeout=600.0)))
    one = {}
    for case in CASES + list(OTHERS) + list(SETS) + ["jax_f64"]:
        m = Model(jcfg_port if case == "jax_f64" else _cfg(case),
                  device="cpu")
        for _ in range(STEPS):
            m.step()
        one[case] = m
    m = Model(_io_cfg(os.path.join(wd, "io1"), "cdf1"), device="cpu",
              enable_history=True)
    for _ in range(STEPS):
        m.step()
    one["io_path"] = m.write_restart()
    return dict(res=res, one=one, wd=wd)


def _leaves(m):
    return [x.numpy() for x in state_leaves(m.state)]


def _equal(got, ref):
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


@pytest.mark.parametrize("case,shape", RUNS,
                         ids=[f"{c}-{s}" for c, s in RUNS])
def test_sharded_steps_equal_one_process(runs, case, shape):
    r = runs["res"][(case, shape)]
    assert len({x["digest"] for x in r}) == 1        # every rank gathers it
    _equal(r[0]["out"], _leaves(runs["one"][case]))
    st = [x["stats"] for x in r]
    assert [x["istep"] for x in st] == [STEPS] * 8
    assert all(x["exchanges"] > 0 for x in st)
    tiles = {x["tile"] for x in st}
    assert tiles == {TILES.get((case, shape),
                               (24, 10) if shape == "2x4" else (12, 20))}


def test_sharded_history_and_cdf1_restart_are_one_process_bytes(runs):
    r = runs["res"][("io_cdf1", "2x4")]
    _equal(r[0]["out"], _leaves(runs["one"]["xla_f64"]))
    one_path = runs["one"]["io_path"]
    assert [x["stats"]["restart"] for x in r] == \
        [one_path.replace("io1", "io8")] * 8
    with open(one_path, "rb") as a, open(r[0]["stats"]["restart"],
                                         "rb") as b:
        assert a.read() == b.read()
    one_h = os.path.join(runs["wd"], "io1", "history")
    files = sorted(os.listdir(one_h))
    assert len(files) == STEPS
    assert sorted(os.listdir(one_h.replace("io1", "io8"))) == files
    for f in files:
        with open(os.path.join(one_h, f), "rb") as a, \
                open(os.path.join(one_h.replace("io1", "io8"), f),
                     "rb") as b:
            assert a.read() == b.read(), f


def test_sharded_pio_restart_resumes_on_one_process(runs):
    r = runs["res"][("io_pio", "4x2")]
    path = r[0]["stats"]["restart"]
    assert {x["stats"]["restart"] for x in r} == {path}
    nfiles = len([f for f in os.listdir(path) if f.endswith(".npy")])
    one = runs["one"]["xla_f64"]
    st, cal = read_restart_sharded(path, one.state)
    assert cal.istep == STEPS
    # every leaf of 2 or more dimensions in 8 tiles, the rest once
    big = sum(x.ndim >= 2 for x in state_leaves(one.state))
    assert nfiles == 8 * big + len(state_leaves(one.state)) - big
    _equal([x.numpy() for x in state_leaves(st)], _leaves(one))


def test_sharded_steps_match_jax_on_eight_devices(runs, devices8):
    """The port's sharded steps (2x4 ranks) against the JAX package's
    model_step with state and forcing sharded on its 2x4 device mesh."""
    _, jcfg = _cfgs("float64")
    m = JModel(jcfg)
    dt = jcfg.setup.dt
    mesh = make_mesh(shape=(2, 4))
    fn = jax.jit(lambda s, fc: jmodel_step(m.static, m.grid, s, fc, dt))
    st, fc = shard_state(mesh, m.state), m.forcing
    for step in range(STEPS):
        t = step * dt
        fc = shard_state(mesh, jget_forcing(
            jcfg, m.grid, t, 1.0 + t / jcst.secday, st.aice, fc))
        st, _ = fn(st, fc)
    assert len(st.aicen.sharding.device_set) == 8
    got = state_from_leaves(
        runs["one"]["jax_f64"].state,
        [torch.as_tensor(a) for a in
         runs["res"][("jax_f64", "2x4")][0]["out"]])
    _compare(_tree(got), _tree(st), "sharded 2x4 vs JAX sharded 2x4",
             "float64")
    _equal([x.numpy() for x in state_leaves(got)],
           _leaves(runs["one"]["jax_f64"]))


def test_sharding_needs_a_mesh():
    with pytest.raises(ValueError, match="mesh"):
        Model(Config().with_overrides(**{"grid.nx_global": 12,
                                         "grid.ny_global": 10}),
              device="cpu", shard=True)


def test_a_one_rank_mesh_steps_as_one_process():
    """Model.shard() on a mesh of one rank without a process group: the
    tiles are the whole arrays, every shift's neighbour is the rank
    itself, and two steps equal the unsharded ones bit for bit."""
    cfg = _cfg("fused_pallas_f32")
    a = Model(cfg, device="cpu")
    b = Model(cfg, device="cpu", mesh=Mesh()).shard()
    assert b.sharded and b.grid.shape == a.grid.shape
    for _ in range(STEPS):
        a.step()
        b.step()
    _equal([x.numpy() for x in state_leaves(b.gather_state())], _leaves(a))
    assert dataclasses.fields(type(b.state)) == dataclasses.fields(
        type(a.state))
