#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cice_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from cice_tpu_torch/csrc (one nvcc
per source, started together), then:

  1. K1 (fused EVP solve) against the plain `evp_solve` on gx1-size EVP
     inputs with nonzero incoming stresses (`measure.evp_problem`): the
     persistent route, which gx1 must take, and the stream route once,
     each of the nine outputs gated on both;
  2. K2 (fused transport) against the plain remap path on the slice's
     initial state, moved by one EVP solve so the ice is in motion;
  3. K3 (flux-only transport) against its plain version, all four outputs,
     on the same moving ice after `construct_fields` and on the dense case
     (`measure.dense_transport_case`: ice moving everywhere), each timed
     beside the bound of the work its data leaves and the every-candidate
     bound;
  4. the dynamics-transport path: Model(gx1pop_dyn).run_dynamics(1) (K1 +
     K2) against the plain path after the same step;
  5. the main path: Model(gx1pop_step, device="cuda").run(3), the full
     coupled step with K1 + K3, checked for finite state and fluxes, no
     out-of-bounds departures, negative mass before the floor no deeper
     than 1e-9, area conservation, a clean `check_state`, the freshwater
     budget within Model.step's 1 % rule, and agreement with the plain path
     (plain EVP loop, plain transport) after the same 3 steps;
  6. one coupled step of gx1pop_step(remap_kernel="auto") (K1 + K2);
  7. restart and history at gx1pop (K1 + K3): Model A runs 4 steps with a
     history stream averaged over 2 steps (cdf1) and npz restarts every 2
     steps, Model B 2 steps, and Model C continues from B's pointer file
     for 2 more; C's state must equal A's bit for bit and C's step-4
     history file A's (both average steps 3 and 4). One cdf1 restart
     round-trips at full width. It prints the restart write and read
     costs, history accumulation (CUDA events) and write costs, and the
     host-clock step with history on and off;
  8. timings with CUDA events after warmup, each beside its computed bound,
     and the phases of the coupled step.

Every path is driven with the launch counters set to 0 just before it and
read just after.

Prints the card's name and power limit, one JSON line of per-kernel
results, and as the last line {"ok": true, "device": {...}}. Any failure
exits nonzero before that line. Needs one CUDA device; imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


class PhaseTimer:
    """`timer` of model_step: CUDA events around every phase; `totals()`
    gives the ms per phase name summed over its calls."""

    def __init__(self):
        self.events = []

    @contextlib.contextmanager
    def __call__(self, name):
        import torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        self.events.append((name, a, b))

    def totals(self) -> dict:
        import torch
        torch.cuda.synchronize()
        out: dict = {}
        for name, a, b in self.events:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def _read_nc(path):
    """(global attributes, dimensions, {variable: (dims, attributes,
    values)}) of a netCDF-3 file."""
    import numpy as np
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        return (dict(f._attributes), dict(f.dimensions),
                {k: (v.dimensions, dict(v._attributes), np.array(v[:]))
                 for k, v in f.variables.items()})


def restart_and_history(C, dev, smi, reset_counters, read_counters) -> dict:
    """Phase 7: restart and history through K1 + K3 at gx1pop. Files go to
    cice_tpu_torch/_build/smoke_io/ and are removed at the end."""
    import shutil

    import numpy as np
    import torch

    from cice_tpu_torch.io import restart as rst
    from cice_tpu_torch.io.history import History
    from cice_tpu_torch.measure import timed_ms
    from cice_tpu_torch.model.driver import Model
    from cice_tpu_torch.model.state import state_leaves

    root = os.path.join(HERE, "cice_tpu_torch", "_build", "smoke_io")
    shutil.rmtree(root, ignore_errors=True)

    def cfg_for(name, **over):
        d = os.path.join(root, name)
        return C.gx1pop_step().with_overrides(**{
            "setup.histfreq": ("1", "x", "x", "x", "x"),
            "setup.histfreq_n": (2, 1, 1, 1, 1),
            "setup.history_format": "cdf1",
            "setup.history_dir": os.path.join(d, "history"),
            "setup.dumpfreq": "1", "setup.dumpfreq_n": 2,
            "setup.restart_format": "npz",
            "setup.restart_dir": os.path.join(d, "restart"),
            "setup.pointer_file": os.path.join(d, "restart",
                                               "ice.restart_file"),
            **over})

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    def mb(path):
        return os.path.getsize(path) / 1e6

    def same_state(x, y, what):
        for i, (a, b) in enumerate(zip(state_leaves(x), state_leaves(y))):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"{what}: leaf_{i} differs")

    try:
        out = {}
        # A: 4 uninterrupted steps; B: 2 steps; C: B's restart + 2 steps
        a = Model(cfg_for("A"), device=dev, enable_history=True)
        reset_counters()
        a.run(4)
        torch.cuda.synchronize()
        la = read_counters()
        b = Model(cfg_for("B"), device=dev, enable_history=True)
        b.run(2)
        ccfg = cfg_for("C", **{"setup.runtype": "continue",
                               "setup.pointer_file":
                                   b.cfg.setup.pointer_file})
        reset_counters()
        c = Model(ccfg, device=dev, enable_history=True)
        c.run(2)
        torch.cuda.synchronize()
        lc = read_counters()
        for what, lau in (("A", la), ("C", lc)):
            if lau["evp_fused"] < 1 or lau["tracer_fluxes"] < 1:
                fail(f"a kernel of the restart run {what} was not "
                     f"launched: {lau}")
        same_state(c.state, a.state, "restarted run C vs uninterrupted A "
                   "after 4 steps")
        if c.calendar != a.calendar:
            fail(f"calendars differ: {c.calendar} vs {a.calendar}")
        name = "iceh.1." + a.calendar.timestamp() + ".nc"
        ha = _read_nc(os.path.join(a.cfg.setup.history_dir, name))
        hc = _read_nc(os.path.join(ccfg.setup.history_dir, name))
        if ha[:2] != hc[:2] or list(ha[2]) != list(hc[2]):
            fail("history files of A and C differ in layout")
        for k, (dims, attrs, vals) in ha[2].items():
            cd, ca, cv = hc[2][k]
            if cd != dims or ca != attrs or not np.array_equal(vals, cv):
                fail(f"history variable {k} differs between A and C")
        # the step-4 file averages steps 3 and 4: hours 2 to 4 of the run
        tb = ha[2]["time_bounds"][2]
        masked = [v for k, (_d, at, v) in ha[2].items()
                  if at.get("cell_methods") == b"time: mean"]
        if not all(np.isfinite(v).all() for v in masked) or \
                not np.allclose(tb, [[2 / 24, 4 / 24]], rtol=0, atol=1e-12):
            fail(f"history file of A: non-finite values or time bounds "
                 f"{tb.tolist()}")
        print(f"restart and history at gx1pop on {smi}: C (restarted "
              f"from B's step-2 npz restart) equals A (4 steps) bit for "
              f"bit in all {len(state_leaves(a.state))} leaves; step-4 "
              f"history files equal ({len(ha[2])} variables, "
              f"{len(masked)} averaged over steps 3 and 4); launches A "
              f"{la}, C {lc}")
        out["launches"] = {"A": la, "C": lc}

        # restart costs: npz (the driver's dump) and a cdf1 round trip
        for fmt in ("npz", "cdf1"):
            d = os.path.join(root, f"rt_{fmt}")
            ptr = os.path.join(d, "pointer")
            w_ms, path = host_ms(lambda: rst.write_restart(
                d, a.state, a.calendar, ptr, fmt=fmt))
            r_ms, (st, cal) = host_ms(lambda: rst.read_restart(ptr, a.state))
            same_state(st, a.state, f"{fmt} restart round trip")
            if cal != a.calendar:
                fail(f"{fmt} restart round trip: calendar {cal}")
            out[f"restart_{fmt}"] = dict(write_ms=w_ms, read_ms=r_ms,
                                         mb=mb(path))
            print(f"restart {fmt} at gx1pop on {smi}: write {w_ms:.1f} ms, "
                  f"read {r_ms:.1f} ms (host clock, device copies "
                  f"included), {mb(path):.1f} MB, round trip exact")

        # history costs on A's last state: accumulation by CUDA events,
        # the cdf1 write on the host clock
        h = History(a.cfg, a.grid, directory=os.path.join(root, "h"))
        acc_ms = timed_ms(lambda: h.accum(a.state, a.flux, a.forcing), 3)
        w_ms, path = host_ms(lambda: h.write_stream(h.streams[0],
                                                    a.calendar, "cdf1"))
        rows = h.streams[0].acc.shape[0]
        out["history"] = dict(accum_ms=acc_ms, write_ms=w_ms, mb=mb(path),
                              rows=rows, fields=len(h.fields))
        print(f"history at gx1pop on {smi}: accum {acc_ms:.3f} ms per step "
              f"(CUDA events; {len(h.fields)} fields, {rows} rows of "
              f"{a.grid.shape[0]}x{a.grid.shape[1]}), cdf1 write "
              f"{w_ms:.1f} ms (host clock), {mb(path):.1f} MB")

        # the coupled step with history on and off, in turns on one model
        # (a daily stream: no file is due in these 17 hourly steps)
        m = Model(C.gx1pop_step().with_overrides(**{
            "setup.histfreq": ("d", "x", "x", "x", "x"),
            "setup.history_dir": os.path.join(root, "hd")}),
            device=dev, enable_history=True)
        hist = m.history
        m.run(1)
        steps = {"off": [], "on": []}
        for label in ("off", "on", "on", "off") * 2:
            m.history = hist if label == "on" else None
            ms, _ = host_ms(lambda: m.run(2))
            steps[label].append(ms / 2)
        out["step_ms"] = steps
        print(f"coupled step at gx1pop on {smi}, ms per step (host clock, "
              f"2 steps each, in the order off on on off off on on off on "
              f"one model): history off {steps['off']}, on {steps['on']}")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    from cice_tpu_torch.columns.ridging import ridge_ice
    from cice_tpu_torch.dynamics import remap_exact as rx
    from cice_tpu_torch.dynamics.evp import evp_solve
    from cice_tpu_torch.kernels import _build, evp as kevp, remap as kremap
    from cice_tpu_torch.measure import (bound_ms, dense_transport_case,
                                        evp_problem, flux_case,
                                        gpu_name_and_power_limit, timed_ms)
    from cice_tpu_torch.model.diagnostics import check_state
    from cice_tpu_torch.model.driver import Model
    from cice_tpu_torch.model.flux import FLUXOUT_FIELDS
    from cice_tpu_torch.model.step import step_dyn_horiz

    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"({_build.build_dir()})")
    smi = gpu_name_and_power_limit()
    print(smi)
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    cfg = C.gx1pop_dyn().with_overrides(**{"setup.conserv_check": True})
    dt = cfg.setup.dt

    # ---- K1: fused EVP vs plain evp_solve ------------------------------
    m = Model(cfg, device=dev)
    grid = m.grid
    ny, nx = grid.shape
    args, kw = evp_problem(grid, cfg.dynamics, dt, dev)
    p = args[1]
    ref = evp_solve(*args, **kw)
    got = kevp.evp_solve_fused(*args, **kw)
    torch.cuda.synchronize()
    scale = float(torch.sqrt(ref[0] ** 2 + ref[1] ** 2).max())
    K1_OUT = ("uvel", "vvel", "stressp", "stressm", "stress12", "strintx",
              "strinty", "taubx", "tauby")

    def hold_k1(outs, route):
        """Every output of a K1 solve against evp_solve: u/v within 1e-4 of
        the largest speed, each output's max abs error within 1e-5 of that
        output's max |ref|. Returns (rel u/v error, max abs error)."""
        err = float(torch.sqrt((outs[0] - ref[0]) ** 2 +
                               (outs[1] - ref[1]) ** 2).max())
        rel = err / max(scale, 1e-30)
        errs = {}
        for nm, g, r in zip(K1_OUT, outs, ref):
            if g.shape != r.shape or not bool(torch.isfinite(g).all()):
                fail(f"K1 route {route}: {nm} has the wrong shape or is not "
                     "finite")
            errs[nm] = (float((g - r).abs().max()), float(r.abs().max()))
        worst = max(e for e, _ in errs.values())
        print(f"K1 evp: route {route} against evp_solve: rel u/v error "
              f"{rel:.3e} (gate 1e-4), max abs error over outputs "
              f"{worst:.3e}; per output (error, max |ref|, gate 1e-5 of it): "
              + ", ".join(f"{nm} {e:.1e} {sc:.3e}"
                          for nm, (e, sc) in errs.items()))
        if not (scale > 1e-3 and rel <= 1e-4):
            fail(f"K1 route {route} disagrees with evp_solve: rel u/v error "
                 f"{rel} at max |u,v| {scale}")
        for nm, (e, sc) in errs.items():
            if not e <= 1e-5 * sc:
                fail(f"K1 route {route} disagrees with evp_solve on {nm}: "
                     f"max abs error {e} at max |ref| {sc}")
        return rel, worst

    masked = float(torch.stack(args[4:7])[:, :, ~args[2].iceTmask.bool()]
                   .abs().max())
    for nm, r in zip(K1_OUT[2:7], ref[2:7]):
        if not float(r.abs().max()) > 0:
            fail(f"K1's inputs leave {nm} zero: nothing to hold it against")
    if not masked > 0:
        fail("K1's inputs carry no stress to mask where there is no ice")
    print(f"K1 evp: max |u,v| {scale:.4e} m/s, incoming stresses up to "
          f"{masked:.3e} N/m on cells without ice")
    k1_rel, k1_abs = hold_k1(got, "persistent")
    # the route the wrapper took at gx1, and the other one once
    info = kevp.device_info(0)
    route, tile = kevp.choose_route(ny, nx, info["sm_count"],
                                    info["smem_per_block"],
                                    info["blocks_per_sm"])
    if route != "persistent" or kevp.persistent_launches != 1 or \
            kevp.stream_launches != 0:
        fail(f"K1 at gx1 must run the persistent route: chose {route}, "
             f"counters persistent {kevp.persistent_launches}, stream "
             f"{kevp.stream_launches}")
    blocks = -(-ny // tile[0]) * -(-nx // tile[1])
    print(f"K1 evp: route {route}, tile {tile[0]}x{tile[1]}, {blocks} "
          f"blocks of {info['threads']} threads on {info['sm_count']} SMs, "
          f"{kevp.persistent_smem_bytes(*tile)} B shared memory per block, "
          f"{info['registers']} registers per thread")
    def solve(ndte=p.ndte, **how):
        return kevp.evp_solve_cuda(grid, p._replace(ndte=ndte), *args[2:],
                                   **kw, **how)
    got_s = solve(route="stream")
    torch.cuda.synchronize()
    _, k1s_abs = hold_k1(kevp.unpack_outputs(got_s), "stream")
    k1_ms = timed_ms(lambda: kevp.evp_solve_fused(*args, **kw), 5)
    k1_plain = timed_ms(lambda: evp_solve(*args, **kw), 2)
    # the subcycles alone: a solve with twice as many, less a whole solve
    k1_kernel = timed_ms(lambda: solve(), 5)
    k1_loop = timed_ms(lambda: solve(ndte=2 * p.ndte), 5) - k1_kernel
    k1_stream = timed_ms(lambda: solve(route="stream"), 5)
    k1_stream_loop = timed_ms(
        lambda: solve(route="stream", ndte=2 * p.ndte), 5) - k1_stream
    nb, nf = kevp.bound_bytes_flops(ny, nx, p.ndte)
    k1_bound, k1_by = bound_ms(nb, nf)
    print(f"K1 evp: persistent {k1_ms:.3f} ms per evp_solve_fused, "
          f"{k1_loop:.3f} ms of it the {p.ndte} subcycles "
          f"({1e3 * k1_loop / p.ndte:.2f} us each, one barrier each); "
          f"stream {k1_stream:.3f} ms per solve, {k1_stream_loop:.3f} ms "
          f"its {2 * p.ndte} subcycle launches; plain "
          f"{k1_plain:.3f} ms (ndte={p.ndte}); bound {k1_bound:.4f} ms by "
          f"{k1_by} ({nf / 1e9:.2f} GFLOP at 67 TFLOP/s f32, which counts "
          f"a fused multiply-add as two)")

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
    # the kernel leaves out donor candidates with no moment at all and the
    # reconstructions nobody then reads: the bound counts this run's work
    k2_active, k2_needed = kremap.work_fractions(grid, mom_n, mom_e)
    nb2, nf2 = kremap.bound_bytes_flops(table, am.shape[0] - 1, ny, nx,
                                        k2_active, k2_needed)
    k2_bound, k2_by = bound_ms(nb2, nf2)
    _, nf2_all = kremap.bound_bytes_flops(table, am.shape[0] - 1, ny, nx)
    k2i = kremap.kernel_info(table)
    print(f"K2 transport: kernel {k2_ms:.3f} ms, plain {k2_plain:.3f} ms "
          f"per call (NT={len(table)} in {k2i['chunks']} chunks of up to "
          f"{k2i['chunk']} reconstructions, tile {k2i['tile'][0]}x"
          f"{k2i['tile'][1]}, {k2i['threads']} threads, {k2i['smem']} B "
          f"shared memory per block, {k2i['registers']} registers per "
          f"thread, {k2i['blocks_per_sm']} block(s) per SM); this run's "
          f"moments leave {k2_active:.3f} of 6 donor candidates per edge "
          f"and {100 * k2_needed:.1f}% of the cells' reconstructions to "
          f"do; bound {k2_bound:.4f} ms by {k2_by} ({nb2 / 1e6:.1f} MB, "
          f"{nf2 / 1e9:.2f} GFLOP; with every candidate "
          f"{nf2_all / 1e9:.2f} GFLOP)")

    # ---- K3: flux-only kernel vs its plain version: the same moving ice,
    # and the dense case where the ice moves everywhere ------------------
    ncat = am.shape[0] - 1
    k3 = {}
    for case, targs in (("gx1pop", kargs),
                        ("dense", dense_transport_case(grid, table, ncat,
                                                       dev))):
        fargs, tstack = flux_case(*targs)
        ref_fl = kremap.tracer_fluxes_plain(*fargs)
        got_fl = kremap.tracer_fluxes_fused(*fargs, tstack=tstack)
        torch.cuda.synchronize()
        err, ok = 0.0, True
        for nm, g, r in zip(("mflxe", "mflxn", "mtflxe", "mtflxn"), got_fl,
                            ref_fl):
            sc = float(r.abs().max())
            e = float((g - r).abs().max())
            err = max(err, e)
            o = sc > 0 and g.shape == r.shape and bool(
                ((g - r).abs() <= 2e-5 * r.abs() + 2e-6 * sc).all())
            ok = ok and o
            print(f"K3 fluxes, {case}: {nm} max |ref| {sc:.4e}, max abs "
                  f"error {e:.3e}, within rtol 2e-5 + 2e-6 scale: {o}")
        if not ok:
            fail(f"K3 disagrees with the plain flux path on the {case} case")
        active, needed = kremap.work_fractions(*targs[:3])
        nb, nf = kremap.tracer_fluxes_bound_bytes_flops(table, ncat, ny, nx,
                                                        active, needed)
        ms = timed_ms(lambda: kremap.tracer_fluxes_fused(*fargs,
                                                         tstack=tstack), 20,
                      3)
        k3[case] = dict(ms=ms, err=err, active=active, needed=needed,
                        bound=bound_ms(nb, nf), nb=nb, nf=nf)
        if case == "gx1pop":
            k3_plain = timed_ms(lambda: kremap.tracer_fluxes_plain(*fargs), 3)
    nb_all, nf_all = kremap.tracer_fluxes_bound_bytes_flops(table, ncat, ny,
                                                            nx)
    k3_all_bound, k3_all_by = bound_ms(nb_all, nf_all)
    k3i = kremap.flux_kernel_info()
    k3_ms, k3_abs = k3["gx1pop"]["ms"], max(v["err"] for v in k3.values())
    k3_bound, k3_by = k3["gx1pop"]["bound"]
    print(f"K3 fluxes: tile {k3i['tile'][0]}x{k3i['tile'][1]}, "
          f"{k3i['threads']} threads, {k3i['stages']} buffers of "
          f"{k3i['chunk']} plane groups, {k3i['smem']} B "
          f"shared memory per block, {k3i['registers']} registers per "
          f"thread, {k3i['blocks_per_sm']} block(s) per SM; plain "
          f"{k3_plain:.3f} ms per call on the gx1pop state (NT={len(table)})")
    for case, v in k3.items():
        print(f"K3 fluxes, {case}: kernel {v['ms']:.4f} ms per call; "
              f"{v['active']:.3f} of 6 donor candidates per edge count, "
              f"{100 * v['needed']:.1f}% of the cells are needed; bound "
              f"{v['bound'][0]:.4f} ms by {v['bound'][1]} "
              f"({v['nb'] / 1e6:.1f} MB, {v['nf'] / 1e9:.3f} GFLOP); with "
              f"every candidate {k3_all_bound:.4f} ms by {k3_all_by} "
              f"({nb_all / 1e6:.1f} MB, {nf_all / 1e9:.3f} GFLOP)")

    def reset_counters():
        kevp.launches = kremap.launches = kremap.flux_launches = 0
        kevp.persistent_launches = kevp.stream_launches = 0

    def read_counters():
        if kevp.persistent_launches != kevp.launches or kevp.stream_launches:
            fail(f"K1 left the persistent route at gx1: {kevp.launches} "
                 f"solves, {kevp.persistent_launches} persistent, "
                 f"{kevp.stream_launches} stream")
        return {"evp_fused": kevp.launches,
                "transport_fused": kremap.launches,
                "tracer_fluxes": kremap.flux_launches}

    def compare(s, r, what):
        """Kernel-path state s against plain-path state r: u/v within 1e-3
        of the largest speed, aicen 1e-4, vicen/vsnon 1e-3 m, sst 1e-3 K."""
        du = float(torch.sqrt((s.uvel - r.uvel) ** 2 +
                              (s.vvel - r.vvel) ** 2).max())
        uscale = float(torch.sqrt(r.uvel ** 2 + r.vvel ** 2).max())
        d = {k: float((getattr(s, k) - getattr(r, k)).abs().max())
             for k in ("aicen", "vicen", "vsnon", "sst")}
        print(f"{what}: rel u/v {du / uscale:.3e} (max |u| {uscale:.3e}), "
              + ", ".join(f"{k} {v:.3e}" for k, v in d.items()) + " (abs)")
        if not (du / uscale <= 1e-3 and d["aicen"] <= 1e-4
                and d["vicen"] <= 1e-3 and d["vsnon"] <= 1e-3
                and d["sst"] <= 1e-3):
            fail(f"{what}: the kernel path disagrees with the plain path")

    def check_transport(tc, what):
        # negative mass: the exact remap's signed fragments leave a few
        # ocean cells at the ice edge a little below zero before the floor
        # (in the plain f64 path too); the check bounds how far
        if tc["oob"] or not tc["neg_mass_depth"] <= 1e-9 or \
                not tc["cons_err_area"] < 1e-5:
            fail(f"{what}: transport checks failed: {tc}")

    plain_over = {"dynamics.evp_algorithm": "standard_2d",
                  "dynamics.remap_kernel": "xla"}

    # ---- the dynamics-transport path: one step through K1 + K2 ----------
    dyn_m = Model(cfg, device=dev)
    reset_counters()
    dyn_m.run_dynamics(1)
    torch.cuda.synchronize()
    dyn_launches = read_counters()
    dtc = {k: float(v) for k, v in dyn_m.tchecks.items()}
    print(f"dynamics-transport path: 1 step, launches {dyn_launches}, "
          f"checks {dtc}")
    check_transport(dtc, "dynamics-transport path")
    if dyn_launches["evp_fused"] < 1 or dyn_launches["transport_fused"] < 1:
        fail(f"a kernel of the dynamics-transport path was not launched: "
             f"{dyn_launches}")
    ref_m = Model(cfg.with_overrides(**plain_over), device=dev)
    ref_m.run_dynamics(1)
    compare(dyn_m.state, ref_m.state,
            "dynamics-transport path vs plain path after 1 step")

    # ---- main path: 3 full coupled steps through K1 + K3 ----------------
    steps = 3
    scfg = C.gx1pop_step().with_overrides(**{"setup.conserv_check": True,
                                             "setup.diagfreq": steps})
    main = Model(scfg, device=dev)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    main.run(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    s = main.state
    planes = [s.aicen, s.vicen, s.vsnon, s.uvel, s.vvel, s.stressp,
              s.stressm, s.stress12, s.sst, s.frzmlt, *s.trcrn.values()]
    fl = main.flux
    planes += [getattr(fl, k) for k in FLUXOUT_FIELDS]
    planes += list(fl.ncat_fluxes.values())
    finite = all(bool(torch.isfinite(t).all()) for t in planes)
    tc = {k: float(v) for k, v in main.tchecks.items()}
    rec = main.diag_log[-1]
    wres = abs(rec["bud_water_residual"]) / max(
        abs(rec["bud_dM"]), abs(rec["bud_water_in"]), 1.0)
    cs = {k: float(v) for k, v in check_state(s).items()}
    print(f"main path: {steps} coupled steps in {wall:.3f} s (host clock, "
          f"kernels built, diagnostics on the last step) on {smi}, "
          f"launches {launches}, checks {tc}, finite {finite}, "
          f"check_state {cs}, freshwater residual / budget {wres:.3e}, "
          f"aice max {rec['aice_max']:.4f}, hmax {rec['hmax']:.3f} m")
    if not finite:
        fail("non-finite state or fluxes after the main path")
    check_transport(tc, "main path")
    if cs["unstable"] or cs["nonfinite"]:
        fail(f"check_state: {cs}")
    if not wres <= 1e-2:
        fail(f"freshwater budget residual {wres} of the budget")
    if launches["evp_fused"] < 1 or launches["tracer_fluxes"] < 1:
        fail(f"a kernel of the main path was not launched: {launches}")

    # the same steps on the plain path (plain EVP loop + plain transport)
    ref_m = Model(scfg.with_overrides(**plain_over), device=dev)
    ref_m.run(steps)
    rtc = {k: float(v) for k, v in ref_m.tchecks.items()}
    print(f"plain path checks {rtc}")
    if rtc["neg_mass"] != tc["neg_mass"] or rtc["oob"] != tc["oob"]:
        fail("the kernel and plain paths raise different transport flags")
    compare(s, ref_m.state, f"main path vs plain path after {steps} steps")

    # ---- one coupled step through K1 + K2 (remap_kernel='auto') ---------
    auto_m = Model(C.gx1pop_step(remap_kernel="auto").with_overrides(
        **{"setup.conserv_check": True}), device=dev)
    reset_counters()
    auto_m.run(1)
    torch.cuda.synchronize()
    auto_launches = read_counters()
    atc = {k: float(v) for k, v in auto_m.tchecks.items()}
    print(f"coupled step with remap_kernel='auto': launches "
          f"{auto_launches}, checks {atc}")
    check_transport(atc, "coupled step with remap_kernel='auto'")
    if auto_launches["evp_fused"] < 1 or \
            auto_launches["transport_fused"] < 1:
        fail(f"a kernel of the 'auto' coupled step was not launched: "
             f"{auto_launches}")

    # ---- restart and history at gx1pop through K1 + K3 -----------------
    rh = restart_and_history(C, dev, smi, reset_counters, read_counters)

    # ---- phase timings on the main path's state -------------------------
    fc = main.forcing
    dyn_ms = timed_ms(lambda: step_dyn_horiz(main.static, grid, main.state,
                                             fc, fc.strax, fc.stray, dt), 3)
    tr_ms = timed_ms(lambda: rx.horizontal_remap_exact(
        grid, main.state, main.static.registry, fc.Tf, dt,
        l_dp_midpt=True, flux_kernel="fused_full"), 5)
    tr3_ms = timed_ms(lambda: rx.horizontal_remap_exact(
        grid, main.state, main.static.registry, fc.Tf, dt,
        l_dp_midpt=True, flux_kernel="fused_pallas"), 5)
    print(f"phases at gx1pop (320x384, ndte=120, NT=25, f32) on {smi}: "
          f"dyn {dyn_ms:.3f} ms (K1 bound {k1_bound:.4f} ms), transport "
          f"through K2 {tr_ms:.3f} ms (K2 bound {k2_bound:.4f} ms), "
          f"transport through K3 {tr3_ms:.3f} ms (K3 bound {k3_bound:.4f} "
          f"ms)")
    psteps = 2
    timer = PhaseTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    main.run(psteps, timer=timer)
    phase_ms = {k: v / psteps for k, v in timer.totals().items()}
    step_ms = (time.perf_counter() - t0) * 1e3 / psteps
    print(f"coupled step on {smi}: {step_ms:.3f} ms per step (host "
          f"clock, {psteps} steps, no diagnostics), phases by CUDA events "
          "(ms per step): " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in phase_ms.items()))

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
         "launches": auto_launches["transport_fused"],
         "max_abs_err": k2_abs,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
        {"name": "tracer_fluxes", "route": "cuda",
         "source": "cice_tpu_torch/csrc/tracer_fluxes.cu",
         "replaces": "cice_tpu/kernels/remap_pallas.py:261",
         "launches": launches["tracer_fluxes"], "max_abs_err": k3_abs,
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": None,
         "ms_dense": k3["dense"]["ms"],
         "bound_ms_dense": k3["dense"]["bound"][0],
         "bound_ms_every_candidate": k3_all_bound},
    ]
    out = {"kernels": results}
    # ridging passes on the main path's last state and deformation
    *_, rdg = ridge_ice(scfg, s.aicen, s.vicen, s.vsnon, s.trcrn,
                        divu=fl.divu, Delta=fl.Delta, dt=dt,
                        hin_max=main.static.hin_max,
                        registry=main.static.registry)
    print(f"ridge_ice at gx1pop after {steps} steps: {rdg['npass']} "
          "pass(es)")

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(out, gpu=smi, dyn_ms=dyn_ms, transport_ms=tr_ms,
                       transport_k3_ms=tr3_ms, main_path_s=wall,
                       step_ms=step_ms, phase_ms=phase_ms,
                       k1_rel_err=k1_rel, k1_subcycles_ms=k1_loop,
                       k1_kernel_ms=k1_kernel, k1_stream_ms=k1_stream,
                       k1_stream_subcycles_ms=k1_stream_loop,
                       k1_stream_max_abs_err=k1s_abs,
                       k1_tile=tile, k1_blocks=blocks,
                       k1_registers=info["registers"], k2_info=k2i,
                       k2_active_candidates=k2_active,
                       k2_needed_cells=k2_needed, k3_info=k3i,
                       k3_cases={c: dict(v, bound=list(v["bound"]))
                                 for c, v in k3.items()},
                       launches={"main": launches, "auto": auto_launches,
                                 "dyn": dyn_launches},
                       freshwater_residual=wres, ridge_passes=rdg["npass"],
                       transport_checks=tc, restart_history=rh), f,
                  indent=1)
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
