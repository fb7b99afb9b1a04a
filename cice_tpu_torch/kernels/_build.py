"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with `nvcc` into a shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes seconds).
Libraries go to `cice_tpu_torch/_build/` (or $CICE_TPU_TORCH_BUILD), named by
a hash of the source and flags, so an edited source rebuilds. Nothing here
runs at import time: the first call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("evp_fused", "transport_fused", "tracer_fluxes",
           "bl99_column")

# -fmad=false keeps every multiply and add separately rounded, as the plain
# PyTorch versions compute them, so kernel and plain version agree to
# rounding of the summation order only
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}


def build_dir() -> str:
    return os.environ.get("CICE_TPU_TORCH_BUILD", os.path.join(_PKG, "_build"))


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"lib{name}_{h.hexdigest()[:12]}.so")


def build(names=SOURCES) -> dict:
    """Compile every named source that is not built yet, one `nvcc` process
    per source, all started together. Returns {name: library path}."""
    os.makedirs(build_dir(), exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, n + ".cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp, out)
    errors = []
    for n, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu. Where it is not built yet,
    every source not built yet is compiled at once (their nvcc processes
    run side by side, so a checkout's first run waits for the slowest
    rather than for each kernel as it is first needed)."""
    if name not in _LIBS:
        path = _lib_path(name)
        if not os.path.exists(path):
            build(tuple(dict.fromkeys(SOURCES + (name,))))
        _LIBS[name] = ctypes.CDLL(path)
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a kernel entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (cudaError_t)")
