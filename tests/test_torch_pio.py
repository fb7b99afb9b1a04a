"""PyTorch port vs JAX package: sharded files (cice_tpu_torch.io.pio, the
io_pio2 analogue) against tests/test_pio.py.

A field round-trips bit for bit unsharded and from 2x4 gloo ranks (8
spawned processes, each writing its tile); the JAX package reads the
port's shards onto its own shardings and the port reads JAX's. A restart
written by the JAX package on a (2,4) mesh reads into the port on one
rank and on 4x2 ranks; one written by the port on 2x4 ranks reads into
the JAX package on a (4,2) sharding; both bit for bit. Under the
background writer a manifest waits for its shard and the pointer for
every manifest (the JAX package writes both at once while the shards are
queued). A Model with restart_format='pio' resumes bit for bit.
"""

import dataclasses
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402

from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu.io import pio as jpio  # noqa: E402
from cice_tpu.model.driver import Model as JModel  # noqa: E402
from cice_tpu.parallel.mesh import grid_sharding, make_mesh, shard_state  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.calendar import Calendar  # noqa: E402
from cice_tpu_torch.config import Config  # noqa: E402
from cice_tpu_torch.io import pio  # noqa: E402
from cice_tpu_torch.io.async_writer import AsyncWriter  # noqa: E402
from cice_tpu_torch.model.driver import Model  # noqa: E402
from cice_tpu_torch.model.state import state_leaves  # noqa: E402
from cice_tpu_torch.parallel import spawn  # noqa: E402

import test_torch_rank_jobs as jobs  # noqa: E402

SMALL = {"grid.nx_global": 16, "grid.ny_global": 16,
         "grid.grid_format": "rect", "grid.kmt_type": "none",
         "forcing.atm_data_type": "box2001",
         "forcing.ocn_data_type": "box2001"}


def _port_state(jstate):
    """The JAX state as the port's State (on the CPU)."""
    d = {f.name: jax.tree.map(np.asarray, getattr(jstate, f.name))
         for f in dataclasses.fields(jstate)}
    return convert.state_from_numpy(d, "cpu")


def _cal(jcal):
    return {k: getattr(jcal, k) for k in ("calendar_type", "year", "month",
                                          "day", "sec", "istep",
                                          "year_init")}


@pytest.fixture(scope="module")
def world(tmp_path_factory, devices8):
    """The JAX restart on a (2,4) mesh, then one launch of 8 ranks: a
    field from 2x4 ranks, the port's restart from 2x4 ranks, JAX's restart
    read on 4x2 ranks, then fields and a restart from a 1x4 mesh of ranks
    4-7 (a group without rank 0)."""
    root = tmp_path_factory.mktemp("pio")
    jm = JModel(JConfig().with_overrides(**SMALL))
    jdir = jpio.write_restart_sharded(
        str(root / "jax"), shard_state(make_mesh((2, 4)), jm.state),
        jm.calendar, str(root / "jax" / "ptr"))
    state = _port_state(jm.state)
    fields = {"fld": np.random.RandomState(1).randn(16, 32).astype(
        np.float32), "stack": np.random.RandomState(2).randn(3, 8, 12)}
    fpath = spawn.save(fields, str(root / "fields.pkl"))
    spath = spawn.save(convert.state_to_numpy(state), str(root / "st.pkl"))
    small = {"scalar": np.float64(2.5), "line": np.arange(7.0),
             "fld": fields["fld"]}
    smallpath = spawn.save(small, str(root / "small.pkl"))
    res = spawn.launch(
        [(jobs.write_fields, dict(fields=fpath, dirpath=str(root / "f"),
                                  shape=(2, 4)), 8),
         (jobs.write_restart, dict(state=spath, calendar=_cal(jm.calendar),
                                   dirpath=str(root / "port"), shape=(2, 4),
                                   pointer_file=str(root / "port" / "ptr")),
          8),
         (jobs.read_restart, dict(path=str(root / "jax" / "ptr"),
                                  template=spath, shape=(4, 2)), 8),
         (jobs.write_on_last_ranks, dict(
             nranks=4, fields=smallpath, state=spath,
             calendar=_cal(jm.calendar), dirpath=str(root / "last"),
             pointer_file=str(root / "last" / "ptr")), 8)],
        8, str(root), timeout=300.0)
    return dict(root=root, jm=jm, jdir=jdir, state=state, fields=fields,
                small=small, res=res)


def test_field_roundtrip_unsharded(tmp_path):
    x = torch.as_tensor(np.random.RandomState(0).randn(5, 12, 16)
                        .astype(np.float32))
    man = pio.write_field_sharded(str(tmp_path), "x", x)
    assert len(man["shards"]) == 1 and man["nprocs"] == 1
    np.testing.assert_array_equal(
        pio.read_field_sharded(str(tmp_path), "x").numpy(), x.numpy())
    np.testing.assert_array_equal(
        np.asarray(jpio.read_field_sharded(str(tmp_path), "x")), x.numpy())
    jpio.write_field_sharded(str(tmp_path), "j", jax.numpy.asarray(x.numpy()))
    np.testing.assert_array_equal(
        pio.read_field_sharded(str(tmp_path), "j").numpy(), x.numpy())


def test_field_roundtrip_across_ranks(world, devices8):
    """Every rank writes its tile (one file each); the port reads the
    whole, the JAX package reads it onto (2,4) and (4,2) shardings."""
    d = str(world["root"] / "f")
    for name, x in world["fields"].items():
        mans = [r[name] for r in world["res"][0]]
        assert all(len(m["shards"]) == 1 and m["nprocs"] == 8 for m in mans)
        assert len([p for p in os.listdir(d)
                    if p.startswith(name + ".p")]) == 8
        np.testing.assert_array_equal(
            pio.read_field_sharded(d, name).numpy(), x)
        for shape in ((2, 4), (4, 2)):
            shd = grid_sharding(make_mesh(shape), x.ndim - 2)
            y = jpio.read_field_sharded(d, name, sharding=shd)
            np.testing.assert_array_equal(np.asarray(y), x)


def _assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf_{i}")


def test_jax_restart_reads_on_one_and_on_4x2_ranks(world):
    want = jax.tree.leaves(world["jm"].state)
    tmpl = world["state"]
    st, cal = pio.read_restart_sharded(str(world["root"] / "jax" / "ptr"),
                                       tmpl)
    assert cal.istep == world["jm"].calendar.istep
    _assert_leaves_equal([x.numpy() for x in state_leaves(st)], want)
    r = world["res"][2]
    assert len({x["digest"] for x in r}) == 1
    _assert_leaves_equal(r[0]["out"], want)


def test_port_restart_from_2x4_ranks_reads_into_jax_on_4x2(world):
    d = world["res"][1][0]
    assert all(x == d for x in world["res"][1])      # every rank: one dir
    with open(world["root"] / "port" / "ptr") as f:
        assert f.read().strip() == d
    assert len([p for p in os.listdir(d) if p.startswith("leaf_0.")]) == 16
    template = shard_state(make_mesh((4, 2)), world["jm"].state)
    st, cal = jpio.read_restart_sharded(str(world["root"] / "port" / "ptr"),
                                        template)
    assert cal.istep == world["jm"].calendar.istep
    _assert_leaves_equal(jax.tree.leaves(st),
                         [x.numpy() for x in state_leaves(world["state"])])


def test_a_mesh_without_rank_0_writes_every_array(world):
    """On a mesh whose group leaves out rank 0 its first rank (4) writes
    the arrays of fewer than two dimensions, the unnumbered manifests,
    meta.json and the pointer; the restart reads back bit for bit."""
    r = world["res"][3]
    assert r[:4] == [None] * 4
    d = str(world["root"] / "last")
    for name, x in world["small"].items():
        assert os.path.exists(os.path.join(d, f"{name}.manifest.json"))
        got = pio.read_field_sharded(d, name).numpy()
        assert got.shape == np.shape(x)
        np.testing.assert_array_equal(got, x)
    assert [m is None for m in (x["fields"]["line"] for x in r[4:])] == \
        [False, True, True, True]
    ddir = r[4]["restart"]
    with open(world["root"] / "last" / "ptr") as f:
        assert f.read().strip() == ddir
    st, cal = pio.read_restart_sharded(ddir, world["state"])
    assert cal.istep == world["jm"].calendar.istep
    _assert_leaves_equal([x.numpy() for x in state_leaves(st)],
                         [x.numpy() for x in state_leaves(world["state"])])


class _Held:
    """A named pipe at a file's `.tmp` path: a worker that writes the file
    blocks in open() until `release` reads the pipe. The worker then
    renames the pipe into place; `restore` puts the bytes it wrote there
    instead, as a regular file."""

    def __init__(self, path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.path = path
        self.got = []
        os.mkfifo(path + ".tmp")

    def release(self):
        def drain():
            with open(self.path + ".tmp", "rb") as f:
                self.got.append(f.read())
        t = threading.Thread(target=drain, daemon=True)
        t.start()
        return t

    def restore(self):
        os.remove(self.path)
        with open(self.path, "wb") as f:
            f.write(self.got[0])


@pytest.mark.parametrize("force_python", [False, True],
                         ids=["native", "python"])
def test_under_io_async_the_pointer_waits_for_every_shard(tmp_path,
                                                          force_python):
    """One leaf's shard held: the other leaves land with their manifests,
    the held leaf's manifest and the pointer wait; after the release the
    pointer names the restart, and it reads back bit for bit."""
    cfg = Config().with_overrides(**{"grid.nx_global": 8,
                                     "grid.ny_global": 6})
    st = Model(cfg, device="cpu").state
    cal = Calendar(year=2005, month=1, day=1, sec=3600, istep=1)
    ptr = str(tmp_path / "ptr")
    ddir = str(tmp_path / f"iced.{cal.timestamp()}.pio")
    held = _Held(os.path.join(ddir, "leaf_3.p0s000.npy"))
    w = AsyncWriter(2, force_python=force_python)
    done = threading.Event()
    try:
        assert pio.write_restart_sharded(str(tmp_path), st, cal, ptr,
                                         writer=w) == ddir
        threading.Thread(target=lambda: (w.flush(), done.set()),
                         daemon=True).start()
        assert not done.wait(1.0), "the held shard was not held"
        files = set(os.listdir(ddir))
        assert "leaf_3.manifest.json" not in files
        assert not os.path.exists(ptr)
        assert {"leaf_2.manifest.json", "leaf_2.p0s000.npy"} <= files
    finally:
        t = held.release()
    assert done.wait(30.0), "the writer did not drain"
    t.join(timeout=10)
    assert not t.is_alive()
    held.restore()
    n = len(state_leaves(st))
    with open(ptr) as f:
        assert f.read().strip() == ddir
    assert {f"leaf_{i}.manifest.json" for i in range(n)} <= \
        set(os.listdir(ddir))
    back, cal2 = pio.read_restart_sharded(ptr, st)
    assert cal2 == cal
    _assert_leaves_equal([x.numpy() for x in state_leaves(back)],
                         [x.numpy() for x in state_leaves(st)])
    w.stop()


def test_model_resumes_from_a_pio_restart(tmp_path):
    over = dict(SMALL, **{"setup.restart_format": "pio",
                          "setup.restart_dir": str(tmp_path),
                          "setup.pointer_file": str(tmp_path / "ptr")})
    cfg = Config().with_overrides(**over)
    a = Model(cfg, device="cpu")
    a.run(2)
    path = a.write_restart()
    assert os.path.isdir(path) and path.endswith(".pio")
    b = Model(cfg.with_overrides(**{"setup.runtype": "continue"}),
              device="cpu")
    assert b.calendar == a.calendar
    _assert_leaves_equal([x.numpy() for x in state_leaves(b.state)],
                         [x.numpy() for x in state_leaves(a.state)])
    a.step()
    b.step()
    _assert_leaves_equal([x.numpy() for x in state_leaves(b.state)],
                         [x.numpy() for x in state_leaves(a.state)])
