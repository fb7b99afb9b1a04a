"""File writes of history and restart payloads (PyTorch port of the
synchronous part of cice_tpu/io/async_writer.py).

A payload is serialised to bytes in memory, then written to `<path>.tmp`
and renamed onto `path`, so a reader chasing the restart pointer file never
sees a partial checkpoint. The background writer pool and its native
library (`setup.io_async`) are not ported yet (ROADMAP A7).
"""

from __future__ import annotations

import io
import os


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


def write_bytes(path: str, data: bytes) -> None:
    """Write `data` to `path` atomically (tmp file, then rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
