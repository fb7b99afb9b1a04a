"""The port's background writer and native helpers (cice_tpu_torch/native,
cice_tpu_torch/io/async_writer.py) against the JAX package's: round trips
through the native and the Python workers, the restart pointer that never
runs ahead of its payload, restart and history files through the writer
byte for byte the synchronous ones, a failed build that raises, and the
reproducible sums bit for bit the JAX package's. No JAX step compiles.

A worker is held by a named pipe: a job whose `<path>.tmp` is a FIFO blocks
in its open until the test opens the pipe for reading.
"""

import gc
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

from cice_tpu import native as jnative  # noqa: E402
from cice_tpu_torch import native as tnative  # noqa: E402
from cice_tpu_torch.calendar import Calendar  # noqa: E402
from cice_tpu_torch.config import Config  # noqa: E402
from cice_tpu_torch.io import restart as trestart  # noqa: E402
from cice_tpu_torch.io.async_writer import (AsyncWriter,  # noqa: E402
                                            write_bytes)
from cice_tpu_torch.model.driver import Model  # noqa: E402
from cice_tpu_torch.model.state import (state_leaves,  # noqa: E402
                                        zeros_state)
from cice_tpu_torch.core.grid import make_grid  # noqa: E402

KINDS = pytest.mark.parametrize("force_python", [False, True],
                                ids=["native", "python"])


class Held:
    """A job for `path` whose worker blocks until `release()`: its tmp file
    is a named pipe that nobody reads yet."""

    def __init__(self, path):
        self.path = path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        os.mkfifo(path + ".tmp")
        self.got = []

    def submit(self, writer, payload=b"held"):
        writer.submit(self.path, payload)

    def release(self):
        def drain():
            with open(self.path + ".tmp", "rb") as f:
                self.got.append(f.read())
        t = threading.Thread(target=drain, daemon=True)
        t.start()
        return t


def _small_state(dev="cpu"):
    cfg = Config().with_overrides(**{"grid.nx_global": 8,
                                     "grid.ny_global": 6})
    return zeros_state(cfg, make_grid(cfg, dev))


def _flush(w, timeout=30.0) -> int:
    """w.flush() with a time limit: a writer that never drains fails the
    test instead of hanging the run."""
    out = []
    t = threading.Thread(target=lambda: out.append(w.flush()), daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "the writer did not drain"
    return out[0]


def _pointer(path):
    with open(path) as f:
        return f.read().strip()


@KINDS
def test_round_trip_and_directories(tmp_path, force_python):
    w = AsyncWriter(3, force_python=force_python)
    assert w.native is (not force_python)
    rng = np.random.default_rng(0)
    files = {str(tmp_path / f"d{k % 3}" / "sub" / f"f{k}.bin"):
             rng.bytes(int(rng.integers(0, 500000))) for k in range(12)}
    for p, b in files.items():
        # a payload no one else holds: the workers read it in place, so
        # the writer keeps it alive until it is written
        w.submit(p, bytes(bytearray(b)))
    gc.collect()
    assert _flush(w) == 0 and w.pending() == 0
    for p, b in files.items():
        with open(p, "rb") as f:
            assert f.read() == b
        assert not os.path.exists(p + ".tmp")
    w.stop()


def test_write_bytes_inline_and_the_pointer_after(tmp_path):
    p = str(tmp_path / "a" / "b" / "x.npz")
    ptr = str(tmp_path / "ptr" / "pointer")
    write_bytes(p, b"payload", pointer=(ptr, p + "\n"))
    with open(p, "rb") as f:
        assert f.read() == b"payload"
    assert _pointer(ptr) == p


@KINDS
def test_the_pointer_never_runs_ahead_of_its_payload(tmp_path,
                                                     force_python):
    """One worker held: the restart is queued behind the held job, and the
    pointer still names the previous restart until the payload is on
    disk."""
    st = _small_state()
    d, ptr = str(tmp_path / "restart"), str(tmp_path / "restart" / "ptr")
    cal = Calendar(year=2005, month=1, day=1, sec=0)
    first = trestart.write_restart(d, st, cal, ptr)          # inline
    w = AsyncWriter(1, force_python=force_python)
    held = Held(str(tmp_path / "held" / "block.bin"))
    held.submit(w)
    cal2 = cal.advance(3600.0)
    second = trestart.write_restart(d, st, cal2, ptr, writer=w)
    assert second != first and w.pending() == 2
    assert _pointer(ptr) == first and not os.path.exists(second)
    t = held.release()
    assert _flush(w) == 0
    t.join(timeout=10)
    assert not t.is_alive() and held.got == [b"held"]
    assert _pointer(ptr) == second and os.path.exists(second)
    w.stop()


@KINDS
def test_pointers_keep_their_order_across_workers(tmp_path, force_python):
    """Two workers: restart 1's payload is held while restart 2's lands.
    The pointer stays on restart 0 (restart 2's pointer waits for restart
    1's), then ends on restart 2."""
    st = _small_state()
    d, ptr = str(tmp_path / "restart"), str(tmp_path / "restart" / "ptr")
    cal = Calendar(year=2005, month=1, day=1, sec=0)
    r0 = trestart.write_restart(d, st, cal, ptr)
    w = AsyncWriter(2, force_python=force_python)
    cal1, cal2 = cal.advance(3600.0), cal.advance(7200.0)
    r1 = os.path.join(d, f"iced.{cal1.timestamp()}.npz")
    held = Held(r1)                        # restart 1's payload blocks
    assert trestart.write_restart(d, st, cal1, ptr, writer=w) == r1
    r2 = trestart.write_restart(d, st, cal2, ptr, writer=w)
    for _ in range(200):                   # restart 2's payload lands
        if os.path.exists(r2):
            break
        threading.Event().wait(0.01)
    assert os.path.exists(r2) and _pointer(ptr) == r0
    t = held.release()
    assert _flush(w) == 0
    t.join(timeout=10)
    assert not t.is_alive() and _pointer(ptr) == r2
    # restart 1's payload went through the pipe: it is a whole restart
    copy = str(tmp_path / "r1_copy.npz")
    with open(copy, "wb") as f:
        f.write(held.got[0])
    assert trestart.read_restart(copy, st)[1] == cal1
    w.stop()


@KINDS
def test_many_restarts_under_contention(tmp_path, force_python):
    """More workers than cores and a short switch interval: every payload
    lands, every pointer write keeps its order, the last restart wins."""
    st = _small_state()
    d, ptr = str(tmp_path / "restart"), str(tmp_path / "restart" / "ptr")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        w = AsyncWriter(2 * (os.cpu_count() or 2), force_python=force_python)
        cal = Calendar(year=2005, month=1, day=1, sec=0)
        paths = []
        for _ in range(40):
            cal = cal.advance(3600.0)
            paths.append(trestart.write_restart(d, st, cal, ptr, writer=w))
        assert _flush(w) == 0
        w.stop()
    finally:
        sys.setswitchinterval(old)
    assert all(os.path.exists(p) for p in paths)
    assert _pointer(ptr) == paths[-1]


def test_a_failed_write_is_counted_and_skips_its_pointer(tmp_path):
    w = AsyncWriter(1)
    ptr = str(tmp_path / "ptr")
    (tmp_path / "ptr_target_dir").mkdir()
    # the payload's path is a directory: the rename fails
    w.submit(str(tmp_path / "ptr_target_dir"), b"x",
             (ptr, "should not be written\n"))
    assert _flush(w) == 2
    assert not os.path.exists(ptr)
    w.stop()


def _model_cfg(root, name, **over):
    d = os.path.join(str(root), name)
    return Config().with_overrides(**{
        "grid.nx_global": 12, "grid.ny_global": 10,
        "grid.grid_format": "rect", "grid.kmt_type": "none",
        "forcing.atm_data_type": "box2001",
        "forcing.ocn_data_type": "box2001", "dynamics.ndte": 10,
        "setup.histfreq": ("1", "x", "x", "x", "x"),
        "setup.dumpfreq": "1",
        "setup.history_dir": os.path.join(d, "history"),
        "setup.restart_dir": os.path.join(d, "restart"),
        "setup.pointer_file": os.path.join(d, "restart", "pointer"),
        **over})


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("hist,rest", [("cdf1", "npz"), ("npz", "cdf1")])
def test_model_files_through_the_writer_equal_the_synchronous(tmp_path,
                                                              hist, rest):
    """Two steps with hourly history and dumps, with and without
    `setup.io_async`: the same state, and every file byte for byte (the
    pointer names the same file name in its own directory)."""
    over = {"setup.history_format": hist, "setup.restart_format": rest}
    runs = {}
    for name, io_async in (("sync", False), ("async", True)):
        m = Model(_model_cfg(tmp_path, name, **over,
                             **{"setup.io_async": io_async}), device="cpu",
                  enable_history=True)
        m.run(2)
        assert (m.io_writer is not None) is io_async
        runs[name] = (m, _files(tmp_path / name))
    (ma, fa), (mb, fb) = runs["sync"], runs["async"]
    assert sorted(fa) == sorted(fb) and len(fa) == 5
    for k in fa:
        if k.endswith("pointer"):
            assert fa[k].replace(b"/sync/", b"/async/") == fb[k]
        else:
            assert fa[k] == fb[k], k
    for a, b in zip(state_leaves(ma.state), state_leaves(mb.state)):
        assert torch.equal(a, b)


def test_flush_io_raises_on_failed_writes(tmp_path):
    m = Model(_model_cfg(tmp_path, "bad", **{"setup.io_async": True}),
              device="cpu")
    # a directory where the dump goes: the worker's rename fails
    os.makedirs(os.path.join(m.cfg.setup.restart_dir,
                             f"iced.{m.calendar.timestamp()}.npz"))
    m.write_restart()
    with pytest.raises(IOError, match="background"):
        m.flush_io()


@pytest.mark.parametrize("cc", ["false", "no-such-compiler-anywhere"])
def test_a_failed_build_raises(tmp_path, monkeypatch, cc):
    monkeypatch.setenv("CICE_TPU_TORCH_BUILD", str(tmp_path / "build"))
    monkeypatch.setenv("CC", cc)
    with pytest.raises(RuntimeError, match="native helpers"):
        tnative.load()
    with pytest.raises(RuntimeError, match="native helpers"):
        AsyncWriter(2)
    assert AsyncWriter(1, force_python=True).flush() == 0


def test_reprosum_equals_the_jax_package_bit_for_bit():
    rng = np.random.default_rng(7)
    cases = [rng.standard_normal(10000) * 10.0 ** rng.integers(-8, 8, 10000),
             np.concatenate([[1e16, 1.0, -1e16], rng.random(1000)]),
             rng.random(3) * 1e-300, np.zeros(5), np.array([])]
    for x in cases:
        for perm in (x, x[::-1], rng.permutation(x)):
            assert tnative.reprosum_host(perm) == jnative.reprosum_host(x)
        assert tnative.compsum_host(x) == jnative.compsum_host(x)
    x = cases[0]
    assert tnative.reprosum_host(x) == tnative.reprosum_host(
        rng.permutation(x))


def test_memusage_and_compsum():
    hw, cur = tnative.memusage_highwater_mb(), tnative.memusage_current_mb()
    assert hw > 1.0 and 0.0 < cur <= hw * 1.5
    x = np.array([1.0, 1e100, 1.0, -1e100])
    assert tnative.compsum_host(x) == 2.0 and np.sum(x) == 0.0
