"""Measure the design choices of K1, K2 and K3 on one GPU at the gx1
shapes.

    python -m cice_tpu_torch.tune_kernels [--skip-build-report]
                                   [--only evp transport wrapper fluxes]

Prints, with the card's name and power limit:

- what `nvcc -Xptxas -v` reports for the three sources (registers, spills,
  shared memory) and the instruction counts of the persistent EVP kernel's
  subcycle loop between its block barriers (from `cuobjdump -sass`, where
  the toolkit has it);
- K1 `persistent`: microseconds per subcycle (a solve with 2400 subcycles
  less one with 1200) for several tiles, and for tiles so small that only
  the barrier and the fixed latencies remain; the `stream` route beside it;
- K2: milliseconds per call on the gx1pop state (ice moving in the polar
  caps only) for tiles and chunk sizes, and on a dense case (random ice and
  velocity everywhere, every edge with donors: `measure.
  dense_transport_case`), each checked against the plain version;
- K3: milliseconds per call on the same two cases through the wrapper's
  defaults (`--only wrapper` uses nothing else of the package, so copied
  with measure.py into another tree it times that tree's K3), then for
  4, 8 and 16 plane groups staged per barrier, passed to
  `tracer_fluxes_cuda(chunk=)`, each checked against the plain version
  (max abs error), beside the bounds.

Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import shutil
import subprocess

import torch

from . import config as C
from .core.grid import rectgrid
from .dynamics import remap_exact as rx
from .dynamics.evp import evp_solve
from .kernels import _build, evp as kevp, remap as kremap
from .measure import (bound_ms, dense_transport_case, evp_problem,
                      flux_case, gpu_name_and_power_limit, timed_ms)
from .model.driver import Model
from .model.step import step_dyn_horiz


def build_report() -> None:
    for name in _build.SOURCES:
        src = os.path.join(_build.CSRC, name + ".cu")
        out = os.path.join(_build.build_dir(), name + "_report.so")
        r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                            "-Xptxas", "-v", "-o", out, src],
                           capture_output=True, text=True, check=True)
        fn = ""
        for line in (r.stdout + r.stderr).splitlines():
            m = re.search(r"Compiling entry function '\w*?\d"
                          r"((?:evp|transport|tracer)_[a-z_]*?kernel)E", line)
            if m:
                fn = m.group(1)
            elif "spill" in line or "Used" in line:
                print(f"ptxas {name} {fn}: {line.strip()}")
    cu = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cu):
        print("no cuobjdump: the instruction counts are not measured")
        return
    sass = subprocess.run([cu, "-sass", os.path.join(
        _build.build_dir(), "evp_fused_report.so")], capture_output=True,
        text=True, check=True).stdout
    body = [s for s in sass.split("Function : ") if "persistent" in
            s.splitlines()[0]][0]
    ops = [m.group(1) for m in re.finditer(
        r"/\*[0-9a-f]{4,5}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)", body)]
    bars = [k for k, o in enumerate(ops) if o.startswith("BAR")]
    # barriers: after the load, after the T pass, two inside the grid
    # barrier; the loop starts after the first one's successor block
    names = ("T pass", "U pass and arrival")
    for nm, a, b in zip(names, bars[:2], bars[1:3]):
        mix = collections.Counter(o.split(".")[0] for o in ops[a:b])
        print(f"sass persistent kernel, {nm}: {b - a} instructions between "
              f"block barriers; {mix.most_common(8)}")


def empty_launches(ny: int, nx: int, n: int, dev) -> None:
    """`n` launches of an empty kernel on the grid of K1's stream route
    (blocks of 32 x 8 threads over the (ny, nx) cells)."""
    lib = _build.load("launch_probe")
    lib.empty_launches.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.empty_launches.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.empty_launches(-(-nx // 32), -(-ny // 8), 32, 8, n,
                                    stream), "empty_launches")


def tune_evp(m, dev) -> None:
    cfg, grid = m.cfg, m.grid
    ny, nx = grid.shape
    dt = cfg.setup.dt
    args, kw = evp_problem(grid, cfg.dynamics, dt, dev)
    ref = torch.cat([r.reshape(-1, ny, nx) for r in evp_solve(*args, **kw)])
    info = kevp.device_info(0)
    print(f"K1 device: {info}; chooser: "
          f"{kevp.choose_route(ny, nx, info['sm_count'], info['smem_per_block'], info['blocks_per_sm'])}")

    def per_subcycle(a, k, **how):
        def solve(ndte):
            return kevp.evp_solve_cuda(a[0], a[1]._replace(ndte=ndte), *a[2:],
                                       **k, **how)
        return (timed_ms(lambda: solve(2400), 3) -
                timed_ms(lambda: solve(1200), 3)) / 1.2

    for tile in ((30, 32), (35, 27), (32, 30)):
        how = dict(route="persistent", tile=tile)
        blocks = -(-ny // tile[0]) * -(-nx // tile[1])
        err = float((kevp.evp_solve_cuda(*args, **kw, **how) - ref)
                    .abs().max())
        print(f"K1 persistent gx1 tile {tile}, {blocks} blocks: "
              f"{per_subcycle(args, kw, **how):.3f} us per subcycle, solve "
              f"{timed_ms(lambda: kevp.evp_solve_cuda(*args, **kw, **how), 5):.3f}"
              f" ms, max abs error {err:.1e}")
    print(f"K1 stream gx1: {per_subcycle(args, kw, route='stream'):.3f} us "
          "per subcycle (2 launches)")
    n = 2 * args[1].ndte
    runs = [timed_ms(lambda: empty_launches(ny, nx, n, dev), 5)
            for _ in range(5)]
    print(f"K1 stream gx1: {n} launches of an empty kernel on its grid, 5 "
          f"runs of 5: {min(runs):.3f} to {max(runs):.3f} ms")
    for gy, gx, tile in ((26, 20, (2, 2)), (39, 40, (3, 4))):
        g = rectgrid(gx, gy, kmt_type="default", device=dev)
        a, k = evp_problem(g, cfg.dynamics, dt, dev, ndte=120)
        blocks = -(-gy // tile[0]) * -(-gx // tile[1])
        print(f"K1 persistent {gy}x{gx} grid, tile {tile}, {blocks} blocks "
              f"(barrier and fixed latencies only): "
              f"{per_subcycle(a, k, route='persistent', tile=tile):.3f} us "
              "per subcycle")


def transport_cases(m, dev) -> dict:
    """The two transport inputs K2 and K3 are timed on: the gx1pop state
    moved by one EVP solve (ice moving in the polar caps), and the dense
    case; each (grid, mom_n, mom_e, am, trm, table)."""
    cfg, grid = m.cfg, m.grid
    dt = cfg.setup.dt
    st, _ = step_dyn_horiz(m.static, grid, m.state, m.forcing,
                           m.forcing.strax + 0.1, m.forcing.stray + 0.05, dt)
    table = rx.build_flat_table(m.static.registry)
    am, trm = rx.state_to_tracers(st, m.static.registry, table)
    dxs, dys, _ = rx.departure_points_scaled(grid, st.uvel, st.vvel, dt,
                                             cfg.dynamics.l_dp_midpt)
    mom_n, mom_e = (t.contiguous() for t in rx.edge_moments(grid, dxs, dys))
    return {"gx1pop state": (grid, mom_n, mom_e, am, trm, table),
            "dense case": dense_transport_case(grid, table, am.shape[0] - 1,
                                               dev)}


def tune_transport(cases) -> None:
    for name, case in cases.items():
        active, needed = kremap.work_fractions(*case[:3])
        ref_am, ref_trm = kremap.transport_plain(*case)
        print(f"K2 {name}: {active:.3f} of 6 donor candidates per edge, "
              f"{100 * needed:.1f}% of the cells needed")
        for tile in ((32, 8), (32, 4), (32, 2)):
            for budget in (8, 16, 26):
                how = dict(tile=tile, budget=budget)
                info = kremap.kernel_info(table, **how)
                got_am, got_trm = kremap.transport_cuda(*case, **how)
                err = max(float((got_am - ref_am).abs().max()),
                          float((got_trm - ref_trm).abs().max()))
                ms = timed_ms(lambda: kremap.transport_cuda(*case, **how),
                              10, 2)
                print(f"K2 {name}, tile {tile}, chunks of {budget}: "
                      f"{ms:.3f} ms, max abs error {err:.1e}, "
                      f"{info['chunks']} chunks, {info['smem']} B, "
                      f"{info['registers']} registers, "
                      f"{info['blocks_per_sm']} block(s) per SM")


def time_flux_wrapper(cases) -> None:
    for name, case in cases.items():
        active, needed = kremap.work_fractions(*case[:3])
        fargs, tstack = flux_case(*case)
        ref = kremap.tracer_fluxes_plain(*fargs)
        got = kremap.tracer_fluxes_fused(*fargs, tstack=tstack)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        runs = [timed_ms(lambda: kremap.tracer_fluxes_fused(
            *fargs, tstack=tstack), 20, 3) for _ in range(3)]
        print(f"K3 {name}, the wrapper's defaults: "
              + " / ".join(f"{ms:.4f}" for ms in runs)
              + f" ms (3 runs of 20), max abs error {err:.1e}; {active:.3f}"
              f" of 6 donor candidates per edge, {100 * needed:.1f}% of the "
              "cells needed")


def tune_fluxes(cases) -> None:
    for name, case in cases.items():
        grid, mom_n, mom_e, am, trm, table = case
        ny, nx = grid.shape
        ncat = am.shape[0] - 1
        active, needed = kremap.work_fractions(grid, mom_n, mom_e)
        fargs, tstack = flux_case(*case)
        ref = kremap.tracer_fluxes_plain(*fargs)
        nb, nf = kremap.tracer_fluxes_bound_bytes_flops(table, ncat, ny, nx,
                                                        active, needed)
        every = bound_ms(*kremap.tracer_fluxes_bound_bytes_flops(table, ncat,
                                                                 ny, nx))
        print(f"K3 {name}: {active:.3f} of 6 donor candidates per edge, "
              f"{100 * needed:.1f}% of the cells needed; bound "
              f"{bound_ms(nb, nf)[0]:.4f} ms by {bound_ms(nb, nf)[1]} "
              f"({nb / 1e6:.1f} MB), with every candidate {every[0]:.4f} ms")
        for chunk in (4, 8, 16):
            info = kremap.flux_kernel_info(chunk)
            got = kremap.tracer_fluxes_cuda(*fargs, tstack=tstack,
                                            chunk=chunk)
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            ms = timed_ms(lambda: kremap.tracer_fluxes_cuda(
                *fargs, tstack=tstack, chunk=chunk), 20, 3)
            print(f"K3 {name}, tile {info['tile']}, {info['stages']} buffers "
                  f"of {chunk} plane groups: {ms:.4f} ms, max abs error "
                  f"{err:.1e}, "
                  f"{info['threads']} threads, {info['smem']} B, "
                  f"{info['registers']} registers, {info['blocks_per_sm']} "
                  "block(s) per SM")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-build-report", action="store_true")
    ap.add_argument("--only", nargs="+", default=("evp", "transport",
                                                  "wrapper", "fluxes"),
                    choices=("evp", "transport", "wrapper", "fluxes"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_kernels: no CUDA device")
    print(gpu_name_and_power_limit())
    os.makedirs(_build.build_dir(), exist_ok=True)
    if not args.skip_build_report:
        build_report()
    dev = torch.device("cuda")
    m = Model(C.gx1pop_dyn(), device=dev)
    if "evp" in args.only:
        tune_evp(m, dev)
    cases = transport_cases(m, dev)
    if "transport" in args.only:
        tune_transport(cases)
    if "wrapper" in args.only:
        time_flux_wrapper(cases)
    if "fluxes" in args.only:
        tune_fluxes(cases)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
