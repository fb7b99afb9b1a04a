#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cice_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from cice_tpu_torch/csrc (one nvcc
per source, started together), then:

  1. K1 (fused EVP subcycles) against the plain `evp_solve` on gx1-size
     EVP inputs (the bench.py `_evp_problem` recipe, rebuilt in the port);
  2. K2 (fused transport) against the plain remap path on the slice's
     initial state, moved by one EVP solve so the ice is in motion;
  3. the main path: Model(gx1pop_dyn, device="cuda").run_dynamics(3) with
     the launch counters reset just before and read just after, checked for
     finite state, no out-of-bounds departures, negative mass before the
     floor no deeper than 1e-9, area conservation, the same transport flags
     as the plain path and agreement with its state after the same steps;
  4. timings with CUDA events after warmup, each beside its computed bound.

Prints the card's name and power limit, one JSON line of per-kernel
results, and as the last line {"ok": true, "device": {...}}. Any failure
exits nonzero before that line. Needs one CUDA device; imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet: HBM rate and f32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def timed_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call by CUDA events, after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(nbytes: float, flops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS_PER_S * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "cice_tpu_torch", "csrc")):
        print("chip_smoke: the cice_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    build = os.path.join(HERE, "cice_tpu_torch", "_build")
    os.environ.setdefault("CICE_TPU_TORCH_BUILD", build)
    os.environ.setdefault("CICE_TPU_TORCH_FIXTURES",
                          os.path.join(build, "fixtures"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cice_tpu_torch import config as C
    from cice_tpu_torch.columns.ridging import ice_strength
    from cice_tpu_torch.dynamics import remap_exact as rx
    from cice_tpu_torch.dynamics.common import dyn_prep, evp_params
    from cice_tpu_torch.dynamics.evp import evp_solve
    from cice_tpu_torch.kernels import _build, evp as kevp, remap as kremap
    from cice_tpu_torch.model.driver import Model
    from cice_tpu_torch.model.step import step_dyn_horiz

    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"({_build.build_dir()})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    cfg = C.gx1pop_dyn().with_overrides(**{"setup.conserv_check": True})
    dt = cfg.setup.dt

    # ---- K1: fused EVP vs plain evp_solve (bench._evp_problem recipe) ---
    m = Model(cfg, device=dev)
    grid = m.grid
    ny, nx = grid.shape
    gen = torch.Generator(device="cpu").manual_seed(0)
    tm = grid.tmask.to(torch.float32)
    aice = (torch.clamp(0.5 + 0.5 * torch.rand(grid.shape, generator=gen),
                        0, 1).to(dev) * tm)
    vice = aice * 2.0
    z = torch.zeros(grid.shape, device=dev)
    prep = dyn_prep(grid, cfg.dynamics, dt, aice=aice, vice=vice, vsno=z,
                    aiceU_prev_mask=torch.zeros(grid.shape, dtype=torch.bool,
                                                device=dev),
                    uvel=z, vvel=z, strairxT=z + 0.1, strairyT=z + 0.05,
                    uocn_T=z, vocn_T=z, ss_tltx_T=z, ss_tlty_T=z)
    p = evp_params(cfg.dynamics, dt)
    strength = ice_strength(torch.stack([aice / 5] * 5),
                            torch.stack([vice / 5] * 5), aice, vice,
                            cfg.dynamics)
    z3 = torch.zeros((4,) + grid.shape, device=dev)
    args = (grid, p, prep, strength, z3, z3, z3)
    ref = evp_solve(*args, uocn=z, vocn=z)
    got = kevp.evp_solve_fused(*args, uocn=z, vocn=z)
    torch.cuda.synchronize()
    scale = float(torch.sqrt(ref[0] ** 2 + ref[1] ** 2).max())
    err = float(torch.sqrt((got[0] - ref[0]) ** 2 +
                           (got[1] - ref[1]) ** 2).max())
    k1_rel = err / max(scale, 1e-30)
    k1_abs = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    print(f"K1 evp: max |u,v| {scale:.4e} m/s, rel u/v error {k1_rel:.3e} "
          f"(gate 1e-4), max abs error over outputs {k1_abs:.3e}")
    if not (scale > 1e-3 and k1_rel <= 1e-4):
        fail(f"K1 disagrees with evp_solve: rel error {k1_rel}")
    k1_ms = timed_ms(lambda: kevp.evp_solve_fused(*args, uocn=z, vocn=z), 5)
    k1_plain = timed_ms(lambda: evp_solve(*args, uocn=z, vocn=z), 2)
    const = kevp.pack_const(grid, prep, strength, p.deltaminEVP * grid.tarea,
                            z, z)
    st0 = torch.cat([prep.uvel[None], prep.vvel[None], z3, z3, z3])
    work = st0.clone()
    k1_loop = timed_ms(lambda: kevp.evp_subcycles_cuda(
        const, work.copy_(st0), p, grid.bc.x_cyclic), 5)
    nb, nf = kevp.bound_bytes_flops(ny, nx, p.ndte)
    k1_bound, k1_by = bound_ms(nb, nf)
    stream_ms = (4 * (26 + 14 + 14) * ny * nx * p.ndte /
                 HBM_BYTES_PER_S * 1e3)
    print(f"K1 evp: kernel {k1_ms:.3f} ms per solve with packing and the "
          f"PyTorch tail, {k1_loop:.3f} ms for the {2 * p.ndte} subcycle "
          f"launches alone; plain {k1_plain:.3f} ms (ndte={p.ndte}); bound "
          f"{k1_bound:.4f} ms by {k1_by} ({nf / 1e9:.2f} GFLOP at 67 "
          f"TFLOP/s f32); streaming all 54 planes from HBM every subcycle "
          f"would take {stream_ms:.3f} ms")

    # ---- K2: fused transport vs the plain path on the moving ice --------
    st, _ = step_dyn_horiz(m.static, grid, m.state, m.forcing,
                           m.forcing.strax + 0.1, m.forcing.stray + 0.05, dt)
    table = rx.build_flat_table(m.static.registry)
    am, trm = rx.state_to_tracers(st, m.static.registry, table)
    dxs, dys, oob = rx.departure_points_scaled(grid, st.uvel, st.vvel, dt,
                                               cfg.dynamics.l_dp_midpt)
    mom_n, mom_e = (t.contiguous() for t in rx.edge_moments(grid, dxs, dys))
    kargs = (grid, mom_n, mom_e, am, trm, table)
    ref_am, ref_trm = kremap.transport_plain(*kargs)
    got_am, got_trm = kremap.transport_fused(*kargs)
    torch.cuda.synchronize()
    moving = float(torch.sqrt(dxs ** 2 + dys ** 2).max())
    am_err = float(((got_am - ref_am).abs() /
                    (1e-5 * ref_am.abs() + 1e-7)).max())
    tr_ok, k2_abs = True, float((got_am - ref_am).abs().max())
    for n in range(len(table)):
        r, g = ref_trm[:, n], got_trm[:, n]
        sc = float(r.abs().max()) or 1.0
        k2_abs = max(k2_abs, float((g - r).abs().max()))
        if not bool(((g - r).abs() <= 5e-4 * r.abs() + 5e-5 * sc).all()):
            tr_ok = False
            print(f"K2 tracer {n} ({table[n].name}) off: max abs "
                  f"{float((g - r).abs().max()):.3e}, scale {sc:.3e}")
    print(f"K2 transport: max departure {moving:.3e} cells, oob "
          f"{bool(oob)}, am error / (1e-5 |am| + 1e-7) = {am_err:.3f}, "
          f"tracers within rtol 5e-4 + 5e-5 scale: {tr_ok}")
    if not (moving > 1e-4 and am_err <= 1.0 and tr_ok):
        fail("K2 disagrees with the plain transport path")
    k2_ms = timed_ms(lambda: kremap.transport_fused(*kargs), 10)
    k2_plain = timed_ms(lambda: kremap.transport_plain(*kargs), 3)
    nb2, nf2 = kremap.bound_bytes_flops(table, am.shape[0] - 1, ny, nx)
    k2_bound, k2_by = bound_ms(nb2, nf2)
    print(f"K2 transport: kernel {k2_ms:.3f} ms, plain {k2_plain:.3f} ms "
          f"per call (NT={len(table)}, tile {kremap.pick_tile(len(table))});"
          f" bound {k2_bound:.4f} ms by {k2_by} ({nb2 / 1e6:.1f} MB, "
          f"{nf2 / 1e9:.2f} GFLOP)")

    # ---- main path: 3 dynamics-transport steps through the kernels ------
    steps = 3
    main = Model(cfg, device=dev)
    kevp.launches = 0
    kremap.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    main.run_dynamics(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"evp_fused": kevp.launches, "transport_fused":
                kremap.launches}
    s = main.state
    planes = [s.aicen, s.vicen, s.vsnon, s.uvel, s.vvel, s.stressp,
              s.stressm, s.stress12, *s.trcrn.values()]
    finite = all(bool(torch.isfinite(t).all()) for t in planes)
    tc = {k: float(v) for k, v in main.tchecks.items()}
    print(f"main path: {steps} steps in {wall:.3f} s (host clock, kernels "
          f"built), launches {launches}, checks {tc}, finite {finite}")
    if not finite:
        fail("non-finite state after the main path")
    # negative mass: the exact remap's signed fragments leave a few
    # ocean cells at the ice edge a little below zero before the floor
    # (in the plain f64 path too); the check bounds how far
    if tc["oob"] or not tc["neg_mass_depth"] <= 1e-9 or \
            not tc["cons_err_area"] < 1e-5:
        fail(f"transport checks failed: {tc}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the path was not launched: {launches}")

    # the same steps on the plain path (plain EVP loop + plain transport)
    plain_cfg = cfg.with_overrides(**{"dynamics.evp_algorithm":
                                      "standard_2d",
                                      "dynamics.remap_kernel": "xla"})
    ref_m = Model(plain_cfg, device=dev)
    ref_m.run_dynamics(steps)
    r = ref_m.state
    rtc = {k: float(v) for k, v in ref_m.tchecks.items()}
    print(f"plain path checks {rtc}")
    if rtc["neg_mass"] != tc["neg_mass"] or rtc["oob"] != tc["oob"]:
        fail("the kernel and plain paths raise different transport flags")
    du = float(torch.sqrt((s.uvel - r.uvel) ** 2 +
                          (s.vvel - r.vvel) ** 2).max())
    uscale = float(torch.sqrt(r.uvel ** 2 + r.vvel ** 2).max())
    da = float((s.aicen - r.aicen).abs().max())
    dv = float((s.vicen - r.vicen).abs().max())
    print(f"main path vs plain path after {steps} steps: rel u/v "
          f"{du / uscale:.3e} (max |u| {uscale:.3e}), aicen {da:.3e}, "
          f"vicen {dv:.3e} (abs)")
    if not (du / uscale <= 1e-3 and da <= 1e-4 and dv <= 1e-3):
        fail("main path disagrees with the plain path")

    # ---- phase timings on the main path's state -------------------------
    fc = main.forcing
    dyn_ms = timed_ms(lambda: step_dyn_horiz(main.static, grid, main.state,
                                             fc, fc.strax, fc.stray, dt), 3)
    tr_ms = timed_ms(lambda: rx.horizontal_remap_exact(
        grid, main.state, main.static.registry, fc.Tf, dt,
        l_dp_midpt=True, flux_kernel="fused_full"), 5)
    print(f"phases at gx1pop (320x384, ndte=120, NT=25, f32): dyn "
          f"{dyn_ms:.3f} ms (K1 bound {k1_bound:.4f} ms), transport "
          f"{tr_ms:.3f} ms (K2 bound {k2_bound:.4f} ms)")

    results = [
        {"name": "evp_fused", "route": "cuda",
         "source": "cice_tpu_torch/csrc/evp_fused.cu",
         "replaces": "cice_tpu/kernels/evp_pallas.py:184",
         "launches": launches["evp_fused"], "max_abs_err": k1_abs,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "transport_fused", "route": "cuda",
         "source": "cice_tpu_torch/csrc/transport_fused.cu",
         "replaces": "cice_tpu/kernels/remap_pallas.py:653",
         "launches": launches["transport_fused"], "max_abs_err": k2_abs,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    out = {"kernels": results}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(out, gpu=smi[0], dyn_ms=dyn_ms, transport_ms=tr_ms,
                       main_path_s=wall, k1_rel_err=k1_rel,
                       k1_subcycles_ms=k1_loop,
                       transport_checks=tc), f, indent=1)
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
