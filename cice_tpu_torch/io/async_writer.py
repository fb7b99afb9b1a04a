"""File writes of history and restart payloads, inline or in the background
(PyTorch port of cice_tpu/io/async_writer.py).

The role of the reference's parallel-IO backend that keeps writes off the
model's critical path (io_pio2, cicecore/cicedyn/infrastructure/io/io_pio2/
ice_pio.F90:591): the model loop serialises a payload to bytes in memory
and hands it to a pool of worker threads (`AsyncWriter`: the native pthread
pool of cice_tpu_torch/native/asyncwriter.c, or Python threads when the
caller asks for them), then returns to stepping while the card stays busy.
The workers read the payload in place: a copy into the pool would cost as
much as the page-cache write it hides (both move the bytes through memory
once). `flush()` is the durability barrier: call it before reading
anything back and at the end of a run.

Every file lands atomically (`<path>.tmp`, then rename). A restart's
pointer file is a follow-on of its payload's job: the worker writes it
after the payload has been renamed into place, and pointers are written in
submission order, so a reader chasing the pointer never finds a missing or
partial checkpoint, with any number of workers.
"""

from __future__ import annotations

import io
import os
import queue
import threading
from typing import Optional, Tuple

#: (pointer path, text): a restart's pointer, written after its payload
Pointer = Tuple[str, str]


class SnapshotBytesIO(io.BytesIO):
    """BytesIO whose contents survive close() as `.value`.

    scipy's netcdf_file closes its file object inside close()/__del__ (after
    flushing) and re-flushes on every close while the fp stays open — a
    no-op close() therefore lets the GC rewrite the buffer with polluted
    attributes. Snapshotting at first close and *really* closing avoids both.
    """

    value = b""

    def close(self):
        if not self.closed:
            self.value = self.getvalue()
        super().close()


def _write_atomic(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


class AsyncWriter:
    """FIFO of write jobs drained by `nthreads` background workers: the
    native pool, built on first use (a failed build raises), or Python
    threads with `force_python=True`."""

    def __init__(self, nthreads: int = 2, force_python: bool = False):
        self._handle = None
        self._q: Optional[queue.Queue] = None
        if not force_python:
            from ..native import load
            self._lib = load()
            self._handle = self._lib.cice_aw_start(int(nthreads))
            if not self._handle:
                raise RuntimeError("the native writer started no worker")
            # the payloads the native workers read in place, kept alive
            # until the pool has drained
            self._held: list = []
            return
        self._q = queue.Queue()
        self._cv = threading.Condition()
        self._errors = 0
        self._tickets = 0
        self._ticket_done = 0
        self._threads = [threading.Thread(target=self._py_worker,
                                          daemon=True)
                         for _ in range(max(1, int(nthreads)))]
        for t in self._threads:
            t.start()

    # -- Python workers (the native pool's semantics) -----------------------
    def _py_worker(self):
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            path, data, pointer, ticket = job
            ok = True
            try:
                _write_atomic(path, data)
            except OSError:
                ok = False
            with self._cv:
                if not ok:
                    self._errors += 1
                if pointer is not None:
                    # earlier pointers first (their jobs were popped first)
                    self._cv.wait_for(lambda: self._ticket_done == ticket)
                    if ok:
                        try:
                            _write_atomic(pointer[0], pointer[1].encode())
                        except OSError:
                            self._errors += 1
                    else:
                        self._errors += 1
                    self._ticket_done += 1
                    self._cv.notify_all()
            self._q.task_done()

    # -- API ----------------------------------------------------------------
    @property
    def native(self) -> bool:
        return self._handle is not None

    def submit(self, path: str, data: bytes,
               pointer: Optional[Pointer] = None) -> None:
        """Queue `data` for `path` (and then `pointer`); returns at once.
        The workers read an immutable `bytes` payload in place (another
        buffer type is copied into one first)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if pointer is not None:
            os.makedirs(os.path.dirname(pointer[0]) or ".", exist_ok=True)
        data = bytes(data)
        if self._handle is not None:
            if not self._lib.cice_aw_pending(self._handle):
                self._held.clear()
            self._held.append(data)
            rc = self._lib.cice_aw_submit(
                self._handle, path.encode(), data, len(data),
                None if pointer is None else pointer[0].encode(),
                None if pointer is None else pointer[1].encode())
            if rc != 0:
                raise RuntimeError(f"async submit failed for {path}")
            return
        if self._q is None:
            raise RuntimeError("the writer is stopped")
        ticket = None
        with self._cv:
            if pointer is not None:
                ticket = self._tickets
                self._tickets += 1
            self._q.put((path, data, pointer, ticket))

    def pending(self) -> int:
        """Jobs queued or being written."""
        if self._handle is not None:
            return int(self._lib.cice_aw_pending(self._handle))
        return self._q.unfinished_tasks

    def flush(self) -> int:
        """Block until every queued write is on disk; returns the
        cumulative count of failed writes."""
        if self._handle is not None:
            errs = int(self._lib.cice_aw_flush(self._handle))
            self._held.clear()
            return errs
        self._q.join()
        return self._errors

    def stop(self) -> None:
        """Flush, then end the workers."""
        if self._handle is not None:
            self._lib.cice_aw_stop(self._handle)
            self._handle = None
            self._held.clear()
        elif self._q is not None:
            self._q.join()
            for _ in self._threads:
                self._q.put(None)
            for t in self._threads:
                t.join(timeout=5.0)
            self._q = None

    def __del__(self):  # durability on garbage collection
        try:
            self.stop()
        except Exception:     # interpreter teardown: nothing left to report
            pass


def write_bytes(path: str, data: bytes,
                writer: Optional[AsyncWriter] = None,
                pointer: Optional[Pointer] = None) -> None:
    """Write `data` to `path` atomically, then `pointer` (path, text) if
    given: through `writer`'s workers if given, else inline."""
    if writer is not None:
        writer.submit(path, data, pointer)
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _write_atomic(path, data)
    if pointer is not None:
        os.makedirs(os.path.dirname(pointer[0]) or ".", exist_ok=True)
        _write_atomic(pointer[0], pointer[1].encode())
