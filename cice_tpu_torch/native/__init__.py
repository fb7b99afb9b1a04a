"""Native (C) host helpers, built with `cc` and loaded with ctypes (the
port's copy of cice_tpu/native: asyncwriter.c, memusage.c, reprosum.c).

The reference's native code is C glue (ice_memusage_gptl.c,
ice_shr_reprosum86.c); here one shared object holds the background file
writer, the memory probes and the reproducible host sums. It is built at
first use into `cice_tpu_torch/_build/` (or $CICE_TPU_TORCH_BUILD), named by
a hash of the sources and flags, so an edited source rebuilds. A failed
build raises: nothing falls back to Python behind the caller's back
(`io.async_writer.AsyncWriter(force_python=True)` is the caller's choice).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..kernels._build import build_dir

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("memusage.c", "reprosum.c", "asyncwriter.c")
CFLAGS = ("-O2", "-fPIC", "-shared")
LIBS = ("-lm", "-lpthread")

_LIBS: dict = {}


def lib_path() -> str:
    """Where the shared object of these sources and flags lives."""
    h = hashlib.sha256(" ".join(CFLAGS + LIBS).encode())
    for s in SOURCES:
        with open(os.path.join(_SRC_DIR, s), "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir(),
                        f"libcice_native_{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the sources with $CC (default `cc`) unless built; returns the
    library's path. Raises RuntimeError with the compiler's output when the
    build fails."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CC", "cc"), *CFLAGS, "-o", tmp,
           *(os.path.join(_SRC_DIR, s) for s in SOURCES), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native helpers: cannot run {cmd[0]}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native helpers: {' '.join(cmd)} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded native library, built on first use; raises if the build
    or the load fails."""
    path = lib_path()
    if path in _LIBS:
        return _LIBS[path]
    lib = ctypes.CDLL(build())
    dbl, ptr, size = ctypes.c_double, ctypes.c_void_p, ctypes.c_size_t
    dptr, cstr = ctypes.POINTER(ctypes.c_double), ctypes.c_char_p
    sigs = {
        "cice_memusage_highwater": ([], dbl),
        "cice_memusage_current": ([], dbl),
        "cice_reprosum": ([dptr, size], dbl),
        "cice_compsum": ([dptr, size], dbl),
        "cice_aw_start": ([ctypes.c_int], ptr),
        "cice_aw_submit": ([ptr, cstr, cstr, size, cstr, cstr],
                           ctypes.c_int),
        "cice_aw_flush": ([ptr], ctypes.c_long),
        "cice_aw_pending": ([ptr], ctypes.c_long),
        "cice_aw_stop": ([ptr], None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    _LIBS[path] = lib
    return lib


def memusage_highwater_mb() -> float:
    """High-water resident set of this process (MB)."""
    return float(load().cice_memusage_highwater())


def memusage_current_mb() -> float:
    """Current resident set of this process (MB; -1 where /proc is
    missing)."""
    return float(load().cice_memusage_current())


def _f64(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr, dtype=np.float64).ravel())


def reprosum_host(arr) -> float:
    """Order-invariant (bit-reproducible) host sum of a float64 array."""
    a = _f64(arr)
    return float(load().cice_reprosum(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), a.size))


def compsum_host(arr) -> float:
    """Kahan-Babuska-Neumaier compensated host sum."""
    a = _f64(arr)
    return float(load().cice_compsum(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), a.size))
