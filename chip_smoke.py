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
     and the phases of the coupled step;
  9. file forcing, the tripole seam and the baseline runner, driven through
     the port CLI's functions (`cice_tpu_torch.cli.main`) on the gx3/gx1/
     tx1 fixtures it writes. One full-width gx1pop_step on a y-cyclic
     grid raises naming ROADMAP A9 (no kernel takes that grid, and on the
     card nothing stands in for one) and, with the plain engines named,
     steps with no launch; tx1pop,evp1d raises the same way on the tripole
     grid. Then gx1pop,evp1d for 5 days (120 steps, JRA55 3-hourly
     forcing, clim ocean, daily history and npz restarts) and gx3pop,evp1d
     for 5 days, each through K1 + K2 with 120 launches of each; tx1pop
     for 1 day with the plain EVP loop and the plain transport named
     (evp_algorithm='standard_2d', remap_kernel='xla'), no kernel
     launched. Before it, the fold's halo on the card is
     checked against the CPU. Each run must pass the baseline oracle
     (finite vice, aice <= 1, extent in both hemispheres) and a clean
     `check_state`; it prints the comparison with baselines/r05 (deltas at
     rtol 1e-3, the largest relative delta per key), host ms per step with
     and without the steps that write files, the forcing's ms per step and
     per record read, and the history and restart ms per file. Files go to
     cice_tpu_torch/_build/smoke_baseline/ and are removed;
 10. the C/CD grids, VP, EAP and the other transports at 320x384: K2 and
     K3 against their plain versions on the edge moments of a C-grid state
     (corner means of the face velocities, Bentsen edge areas), max abs
     error 0.0, each timed beside its bound; gx1pop,gridc (5 days where
     the C-grid step stays under ~0.5 s, else 1) and gx1pop,dynpicard
     (6 steps) through the baseline runner as in phase 9, under the labels
     gx1pop+gridc and gx1pop+dynpicard of baselines/r05, with K2 once per
     step and K1 never; one step each of gx1pop with gridcd, eap,
     dynanderson, upwind, vanleer and advection=remap_q (finite, a clean
     `check_state`, K2 once where the exact remap runs, else no launch);
     box2001_config (80x80, upwind) for 24 steps;
 11. the column physics of CICE's standard configuration at 320x384:
     gx1pop_step(remap_kernel='auto') with mushy thermodynamics and
     delta-Eddington shortwave beside BL99 and ccsm3 (ms per step, the
     phases by CUDA events, PyTorch operations and host reads per step);
     K1 and K2
     against their plain versions on the mushy, dEdd state, max abs error
     0.0, each timed beside its bound; gx1pop,evp1d,mushy,dedd for a day
     through the baseline runner (K1 and K2 once per step) with the
     freshwater and area checks on every step and the ice salt budget
     against the salt flux to the ocean; three steps of gx1pop,evp1d alone
     and with each of snwgrain, fsd12, pondtopo, pondsealvl, saltflux, fdrag,
     alt05 and alt06 (finite, aice <= 1, extent in both hemispheres, a
     clean `check_state`, K1 and K2 once per step; ms, peak memory and
     host reads per step);
 12. the biogeochemistry at 320x384: gx1pop_step(remap_kernel='auto') with
     bgcz (the z tracers on a 7-layer brine column: NT=266) for 3 steps
     (K1 + K2; the last two timed by phase, with each phase's peak
     memory), then K1, K2 and K3 against their plain versions on that
     state, max abs error 0.0 on every output, each timed beside the bound
     of this table and this run's moments, K2's chunk count printed; one
     step of gx1pop_step (K1 + K3) from that state; three steps of
     gx1pop,evp1d with each of aerosol, isotope, modal, bgcskl, bgcz,
     zaero, alt03, alt04 and forcing.highfreq=true (finite, aice <= 1,
     extent in both hemispheres, a clean `check_state`; K1 once per step
     where the dynamics are the B-grid fused EVP, K2 once per step where
     the transport is the exact remap; ms, PyTorch operations, host reads
     and peak MB per step); gx1pop,evp1d,bgcz for a day through the
     baseline runner (daily cdf1 history with the zbgc and hbrine groups,
     npz restarts) and 24 steps of gx1pop,evp1d,aerosol, each with the
     freshwater and area checks on every step and, report-only, the
     inventory change of nitrate or of aerosol species 1 beside its
     deposition less its flux to the ocean;
 13. coupling and I/O at 320x384 (K1 + K2 where the dynamics run): (a)
     gx1pop,evp1d for a day (daily cdf1 history, daily npz restart) with
     the background writer off and on: equal final states, byte-identical
     files, the pointer never naming a missing file, the file step split
     into serialisation and write; (b) 7 steps of CoupledIce on a
     standalone Model's forcing imported under coupler names, each equal
     to `model_step` on the imported Forcing bit for bit, the last with
     Sa_tbot + 1 K, which must change the result; the exports finite, in
     range and zero without ice; (c) gx1pop,prescribed for a day (ice_cov
     .npz; no kernel; aice equal to the data times hm after each reset; no
     abort); (d) gx1pop,evp1d,bdyrestore for a day, step 13 equal to
     `model_step` and the nudge bit for bit, untouched outside the zone;
     (e) the gx1 fixture as pop_bin, pop_nc and MOM grids (pop_nc bit for
     bit, MOM within 4 ulp in lat/lon/angle) and one step on pop_nc equal
     to the pop_bin step; (f) the perf sweep at 192x160, 384x320 and
     768x640 through K1 (routes persistent, persistent, stream), stream K1
     against `evp_solve` at 768x640 with max abs error 0.0; (g)
     gx1pop,evp1d,bigdiag for a day (print_points, conserv_check,
     debug_model), host reads per diagnostics record; where bigdiag's
     transport check aborts on the exact remap's known ice-edge cell, that
     abort is printed and the probes run without conserv_check.

Every path is driven with the launch counters set to 0 just before it and
read just after.

Prints the card's name and power limit, one JSON line of per-kernel
results, and as the last line {"ok": true, "device": {...}}. Any failure
exits nonzero before that line. Needs one CUDA device; imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


class PhaseTimer:
    """`timer` of model_step: CUDA events around every phase; `totals()`
    gives the ms per phase name summed over its calls, and `peak_mb` the
    largest allocation above each phase's start (MB, the allocator's host
    count: no sync)."""

    def __init__(self):
        self.events = []
        self.peak_mb: dict = {}

    @contextlib.contextmanager
    def __call__(self, name):
        import torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        a.record()
        yield
        b.record()
        self.events.append((name, a, b))
        self.peak_mb[name] = max(self.peak_mb.get(name, 0.0), (
            torch.cuda.max_memory_allocated() - held) / 1e6)

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


def halo_on_the_card(grid, smi) -> int:
    """The fold's ghost rows on the card against the CPU: a field mirrored
    about the fold, shifted through every location, type and offset of a
    two-row halo, must come out bit for bit the same on both."""
    import torch

    from cice_tpu_torch.core.halo import shift
    ny, nx = grid.shape
    g = torch.Generator().manual_seed(6)
    f = torch.rand((2, ny, nx), generator=g, dtype=torch.float64)
    f = (0.5 * (f + f.flip(-1))).to(grid.dtype)
    fd = f.to(grid.device)
    n = 0
    for loc in range(1, 5):
        for ftype in range(1, 4):
            for dj in (-2, -1, 1, 2):
                for di in (-1, 0, 1):
                    a = shift(fd, dj, di, bc=grid.bc, loc=loc, ftype=ftype)
                    b = shift(f, dj, di, bc=grid.bc, loc=loc, ftype=ftype)
                    if not torch.equal(a.cpu(), b):
                        fail(f"halo {grid.bc} loc {loc} ftype {ftype} "
                             f"({dj}, {di}): card and CPU differ")
                    n += 1
    print(f"halo of {grid.bc} on {ny}x{nx} on {smi}: {n} shifts of a "
          "fold-symmetric field equal on the card and the CPU")
    return n


def plain_evp_on(m, smi) -> float:
    """ms by CUDA events of one plain `evp_solve` (the engine a tripole run
    names) on the model's own grid and subcycle count, on
    `measure.evp_problem`'s inputs."""
    from cice_tpu_torch.dynamics.evp import evp_solve
    from cice_tpu_torch.measure import evp_problem, timed_ms
    args, kw = evp_problem(m.grid, m.cfg.dynamics, m.cfg.setup.dt,
                           m.grid.device)
    ms = timed_ms(lambda: evp_solve(*args, **kw), 2)
    ny, nx = m.grid.shape
    print(f"plain evp_solve on the {ny}x{nx} {m.grid.bc.ns} grid "
          f"(ndte={m.cfg.dynamics.ndte}) on {smi}: {ms:.1f} ms per solve "
          "(CUDA events, 2 after 1 warmup)")
    return ms


BASELINE_ROOT = os.path.join(HERE, "cice_tpu_torch", "_build",
                             "smoke_baseline")


def baseline_runner(dev, smi, reset_counters, read_counters):
    """(cfg_for, run) of the baseline runs under BASELINE_ROOT:
    `cfg_for(opts, label, sets)` builds an option set's Config with its
    files in its own directory; `run(opts, label, sets, expect)` runs it
    through `cli.baseline_model` with history and restarts, checks the
    oracle, `check_state` and the launches, prints the comparison with
    baselines/r05/<label>.json and the host costs, and returns them.
    `each_step(m)`, if given, is called after every step, outside its
    timing."""
    import argparse
    import shutil
    import statistics

    import torch

    from cice_tpu_torch.cli import main as cli
    from cice_tpu_torch.model.diagnostics import check_state

    root = BASELINE_ROOT
    r05 = os.path.join(HERE, "baselines", "r05")

    def cfg_for(opts, label, sets):
        d = os.path.join(root, label)
        sets = list(sets) + [
            f"setup.history_dir={d}/history/",
            f"setup.restart_dir={d}/restart/",
            f"setup.pointer_file={d}/restart/ice.restart_file"]
        return cli.build_config(argparse.Namespace(opts=opts, set=sets))

    def run(opts, label, sets, expect, each_step=None):
        m = cli.baseline_model(cfg_for(opts, label, sets), dev)
        plain_evp_ms = None
        if label == "tx1pop":
            halo_on_the_card(m.grid, smi)
            plain_evp_ms = plain_evp_on(m, smi)
        step_ms, wrote, files = [], [], {"history": [], "restart": []}
        step, write_restart = m.step, m.write_restart
        write_stream = m.history.write_stream

        def timed(kind, fn):
            def call(*a, **k):
                t = time.perf_counter()
                path = fn(*a, **k)
                files[kind].append(((time.perf_counter() - t) * 1e3,
                                    os.path.getsize(path) / 1e6))
                return path
            return call

        def timed_step(*a, **k):
            n = len(files["history"]) + len(files["restart"])
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*a, **k)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            wrote.append(len(files["history"]) + len(files["restart"]) > n)
            if each_step is not None:
                each_step(m)
            return out

        m.write_restart = timed("restart", write_restart)
        m.history.write_stream = timed("history", write_stream)
        m.step = timed_step
        reset_counters()
        t = time.perf_counter()
        m.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = read_counters()
        res = cli.finish_baseline(m, label, os.path.join(root, "archive"),
                                  r05)
        cs = {k: float(v) for k, v in check_state(m.state).items()}
        nsteps = len(step_ms)
        quiet = [x for x, w in zip(step_ms, wrote) if not w]
        busy = [x for x, w in zip(step_ms, wrote) if w]
        forcing_ms = m.timers.get("Forcing") * 1e3 / nsteps
        reads = {k: (ds.records_read, ds.read_seconds * 1e3 /
                     max(ds.records_read, 1))
                 for k, ds in m.datasets.items()}
        per_file = {k: (statistics.mean(x for x, _ in v),
                        statistics.mean(mb for _, mb in v), len(v))
                    for k, v in files.items() if v}
        errs, rel = res["deltas"], res["largest_rel"] or {}
        print(f"baseline {opts} ({label}) on {smi}: {nsteps} steps in "
              f"{wall:.1f} s, launches {launches}; ms per step (host "
              f"clock): {statistics.mean(step_ms):.1f} mean, "
              f"{statistics.median(quiet):.1f} median of the "
              f"{len(quiet)} steps that write no file"
              + (f", {statistics.mean(busy):.1f} mean of the {len(busy)} "
                 "that do" if busy else "")
              + f"; forcing {forcing_ms:.2f} ms per step; records read "
              f"(count, ms each): {reads}; files (ms, MB, count): "
              f"{per_file}; check_state {cs}; oracle "
              f"{'PASS' if res['ok'] else 'FAIL'}")
        print(f"  r05 comparison of {label}: "
              + ("no committed baseline" if errs is None else
                 f"{len(errs)} deltas at rtol {cli.BCMP_RTOL}, largest "
                 "relative delta per key "
                 + json.dumps({k: float(f"{v:.3e}") for k, v in
                               rel.items()})))
        if not res["ok"]:
            fail(f"baseline {label}: the oracle failed ({res['final']})")
        if cs["unstable"] or cs["nonfinite"]:
            fail(f"baseline {label}: check_state {cs}")
        if launches != expect:
            fail(f"baseline {label}: launches {launches}, expected {expect}")
        shutil.rmtree(os.path.join(root, label), ignore_errors=True)
        return dict(steps=nsteps, wall_s=wall, launches=launches,
                    step_ms_mean=statistics.mean(step_ms),
                    step_ms_quiet_median=statistics.median(quiet),
                    step_ms_files_mean=statistics.mean(busy) if busy
                    else None, forcing_ms=forcing_ms, reads=reads,
                    files=per_file, ndeltas=None if errs is None
                    else len(errs), largest_rel=rel,
                    plain_evp_ms=plain_evp_ms,
                    final=res["final"])

    return cfg_for, run


def baseline_runs(dev, smi, reset_counters, read_counters) -> dict:
    """Phase 9: file forcing, the tripole seam and the baseline runner,
    through the port CLI's functions. Files go to BASELINE_ROOT and are
    removed."""
    import shutil

    import torch

    from cice_tpu_torch.cli import main as cli

    shutil.rmtree(BASELINE_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    from cice_tpu_torch.io.fixtures import ensure_baseline_fixtures
    ensure_baseline_fixtures()
    fix_s = time.perf_counter() - t0
    print(f"baseline fixtures (gx3, gx1, tx1 grids; NCAR, JRA55, ocean "
          f"climatology) ready in {fix_s:.1f} s")
    cfg_for, run = baseline_runner(dev, smi, reset_counters, read_counters)

    k12 = {"evp_fused": 120, "transport_fused": 120, "tracer_fluxes": 0}
    none = {"evp_fused": 0, "transport_fused": 0, "tracer_fluxes": 0}
    def raises_a9(m, what):
        try:
            m.step()
        except NotImplementedError as e:
            if "ROADMAP A9" not in str(e):
                fail(f"{what}: raised without naming ROADMAP A9: {e}")
            print(f"{what}: raises on the card, as it must: {e}")
        else:
            fail(f"{what}: stepped on the card although no kernel takes "
                 "the grid")

    try:
        # gx1pop_step on a y-cyclic grid: with K1 and K3 asked for, the step
        # raises; with the plain engines named, it runs and launches nothing
        from cice_tpu_torch import config as C
        from cice_tpu_torch.model.driver import Model
        ycyc = {"grid.ns_boundary_type": "cyclic"}
        raises_a9(Model(C.gx1pop_step().with_overrides(**ycyc), device=dev),
                  "gx1pop_step on a y-cyclic grid")
        m = Model(C.gx1pop_step().with_overrides(**ycyc, **{
            "dynamics.evp_algorithm": "standard_2d",
            "dynamics.remap_kernel": "xla"}), device=dev)
        reset_counters()
        m.step()
        torch.cuda.synchronize()
        launches = read_counters()
        finite = bool(torch.isfinite(m.state.aicen).all())
        print(f"gx1pop_step on a y-cyclic grid with the plain engines named: "
              f"1 step, launches {launches}, finite {finite}")
        if launches != none or not finite:
            fail("gx1pop_step on a y-cyclic grid on the plain engines")
        del m
        raises_a9(cli.baseline_model(cfg_for("tx1pop,evp1d", "tx1pop_k1",
                                             ["setup.npt=1"]), dev),
                  "tx1pop,evp1d (K1 on the tripole grid)")
        return {
            "gx1pop": run("gx1pop,evp1d", "gx1pop", [], k12),
            "gx3pop": run("gx3pop,evp1d", "gx3pop", [], k12),
            "tx1pop": run("tx1pop", "tx1pop",
                          ["setup.npt=1", "dynamics.evp_algorithm=standard_2d",
                           "dynamics.remap_kernel=xla"], none),
            "fixtures_s": fix_s}
    finally:
        shutil.rmtree(BASELINE_ROOT, ignore_errors=True)


def c_grid_and_other_dynamics(dev, smi, reset_counters, read_counters):
    """Phase 10: the C/CD grids, VP, EAP and the other transports at
    gx1pop's full width. (a) K2 and K3 against their plain versions on
    C-grid edge moments (max abs error 0.0), each timed beside its bound;
    (b) gx1pop,gridc and (c) gx1pop,dynpicard through the baseline runner;
    (d) one step of each other option set; (e) box2001_config."""
    import shutil

    import torch

    from cice_tpu_torch import config as C
    from cice_tpu_torch.dynamics import remap_exact as rx
    from cice_tpu_torch.kernels import remap as kremap
    from cice_tpu_torch.measure import bound_ms, flux_case, timed_ms
    from cice_tpu_torch.model.diagnostics import check_state
    from cice_tpu_torch.model.driver import Model
    from cice_tpu_torch.model.step import step_dyn_horiz

    out = {}
    # ---- (a) K2 and K3 on C-grid moments at 320x384 --------------------
    cfg = C.gx1pop_step(remap_kernel="auto").with_overrides(
        **{"grid.grid_ice": "C"})
    m = Model(cfg, device=dev)
    g, dt, fc = m.grid, cfg.setup.dt, m.forcing
    ny, nx = g.shape
    wind = (fc.strax + 0.1, fc.stray + 0.05)
    st, _ = step_dyn_horiz(m.static, g, m.state, fc, *wind, dt)
    dyn_c_ms = timed_ms(lambda: step_dyn_horiz(m.static, g, m.state, fc,
                                               *wind, dt), 2)
    uc, vc, ea_e, ea_n = rx.corner_velocities_and_edge_areas(g, st, "C", dt)
    dxs, dys, oob = rx.departure_points_scaled(g, uc, vc, dt,
                                               cfg.dynamics.l_dp_midpt)
    mom_n, mom_e = (t.contiguous() for t in rx.edge_moments(
        g, dxs, dys, ea_e, ea_n))
    table = rx.build_flat_table(m.static.registry)
    am, trm = rx.state_to_tracers(st, m.static.registry, table)
    kargs = (g, mom_n, mom_e, am, trm, table)
    fargs, tstack = flux_case(*kargs)
    ref2 = kremap.transport_plain(*kargs)
    got2 = kremap.transport_fused(*kargs)
    ref3 = kremap.tracer_fluxes_plain(*fargs)
    got3 = kremap.tracer_fluxes_fused(*fargs, tstack=tstack)
    torch.cuda.synchronize()
    err = lambda got, ref: max(float((a - r).abs().max())
                               for a, r in zip(got, ref))
    finite = all(bool(torch.isfinite(t).all()) for t in (*got2, *got3))
    k2_err, k3_err = err(got2, ref2), err(got3, ref3)
    moving = float(torch.sqrt(dxs ** 2 + dys ** 2).max())
    print(f"C grid at gx1pop (320x384, f32) on {smi}: one C-grid dynamics "
          f"step (evp_c_solve, ndte={cfg.dynamics.ndte}) {dyn_c_ms:.1f} ms; "
          f"max departure {moving:.3e} cells, oob {bool(oob)}; K2 on "
          f"C-grid moments: max abs error {k2_err} against transport_plain;"
          f" K3: {k3_err} against tracer_fluxes_plain; finite {finite}")
    if not (finite and moving > 1e-4 and k2_err == 0.0 and k3_err == 0.0):
        fail("K2 or K3 differs from its plain version on C-grid moments")
    ncat = am.shape[0] - 1
    active, needed = kremap.work_fractions(g, mom_n, mom_e)
    k2 = dict(ms=timed_ms(lambda: kremap.transport_fused(*kargs), 10),
              plain_ms=timed_ms(lambda: kremap.transport_plain(*kargs), 3),
              bound=bound_ms(*kremap.bound_bytes_flops(
                  table, ncat, ny, nx, active, needed)), err=k2_err)
    k3 = dict(ms=timed_ms(lambda: kremap.tracer_fluxes_fused(
        *fargs, tstack=tstack), 20, 3),
        plain_ms=timed_ms(lambda: kremap.tracer_fluxes_plain(*fargs), 3),
        bound=bound_ms(*kremap.tracer_fluxes_bound_bytes_flops(
            table, ncat, ny, nx, active, needed)), err=k3_err)
    for name, k in (("K2", k2), ("K3", k3)):
        print(f"{name} on C-grid moments: kernel {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.3f} ms per call; {active:.3f} of 6 donor "
              f"candidates per edge count, {100 * needed:.1f}% of the "
              f"cells are needed; bound {k['bound'][0]:.4f} ms by "
              f"{k['bound'][1]}")
    out.update(k2_cgrid=k2, k3_cgrid=k3, dyn_c_ms=dyn_c_ms,
               cgrid_active=active, cgrid_needed=needed)
    del m, st, kargs, fargs, tstack, got2, ref2, got3, ref3

    cfg_for, run = baseline_runner(dev, smi, reset_counters, read_counters)
    try:
        # ---- (b) gx1pop,gridc and (c) gx1pop,dynpicard ------------------
        # 5 days where the C-grid step stays under ~0.5 s (the dynamics
        # step above plus ~150 ms for the rest of a gx1pop step), else 1
        days = 5 if dyn_c_ms + 150.0 < 500.0 else 1
        out["gridc"] = run("gx1pop,gridc", "gx1pop+gridc",
                           [f"setup.npt={days}"],
                           {"evp_fused": 0, "transport_fused": 24 * days,
                            "tracer_fluxes": 0})
        # 6 hourly steps: a VP step takes 13-17 s (NVIDIA H100 80GB HBM3,
        # 700 W)
        out["dynpicard"] = run("gx1pop,dynpicard", "gx1pop+dynpicard",
                               ["setup.npt=6", 'setup.npt_unit="1"'],
                               {"evp_fused": 0, "transport_fused": 6,
                                "tracer_fluxes": 0})
        # ---- (d) one full-width step of each other option set ----------
        out["single"] = {}
        for opts, sets, k2_per_step in (
                ("gx1pop,gridcd", [], 1), ("gx1pop,eap", [], 1),
                ("gx1pop,dynanderson", [], 1), ("gx1pop,upwind", [], 0),
                ("gx1pop,vanleer", [], 0),
                ("gx1pop", ["dynamics.advection=remap_q"], 0)):
            label = opts + "".join(f"+{x.split('=')[1]}" for x in sets)
            sm = Model(cfg_for(opts, label.replace(",", "_"), sets),
                       device=dev)
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sm.step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = read_counters()
            s = sm.state
            fin = all(bool(torch.isfinite(t).all()) for t in (
                s.aicen, s.vicen, s.vsnon, s.uvel, s.vvel, s.uvelE,
                s.vvelN, s.stressp, s.a11, *s.trcrn.values()))
            cs = {k: float(v) for k, v in check_state(s).items()}
            expect = {"evp_fused": 0, "transport_fused": k2_per_step,
                      "tracer_fluxes": 0}
            print(f"one step of {label} at 320x384 on {smi}: {ms:.1f} ms "
                  f"(host clock, the first step: it reads the forcing's "
                  f"first records), launches {launches}, "
                  f"finite {fin}, check_state {cs}, max |u| "
                  f"{float(s.uvel.abs().max()):.3e}")
            if not fin or cs["unstable"] or cs["nonfinite"] or \
                    launches != expect:
                fail(f"one step of {label}: finite {fin}, check_state {cs},"
                     f" launches {launches} (expected {expect})")
            out["single"][label] = dict(ms=ms, launches=launches)
            del sm
        # ---- (e) box2001_config: 80x80, upwind --------------------------
        bm = Model(C.box2001_config(), device=dev)
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bm.run(24)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        fin = all(bool(torch.isfinite(t).all())
                  for t in (bm.state.aicen, bm.state.vicen, bm.state.uvel))
        print(f"box2001_config (80x80, upwind): 24 steps in {wall:.2f} s, "
              f"launches {launches}, finite {fin}, aice max "
              f"{float(bm.state.aice.max()):.4f}")
        if not fin or any(launches.values()):
            fail("box2001_config: non-finite state or a kernel launched")
        out["box2001_s"] = wall
    finally:
        shutil.rmtree(BASELINE_ROOT, ignore_errors=True)
    return out


MUSHY_DEDD = {"thermo.ktherm": 2, "thermo.tfrz_option": "mushy",
              "shortwave.shortwave": "dEdd"}
#: the other column option sets of phase 11 (c), on top of gx1pop,evp1d
COLUMN_SETS = ("snwgrain", "fsd12", "pondtopo", "pondsealvl", "saltflux",
               "fdrag", "alt05", "alt06")


def column_physics(dev, smi, reset_counters, read_counters):
    """Phase 11: the column physics of CICE's standard configuration at
    gx1pop's full width. (a) gx1pop_step(remap_kernel='auto') with mushy
    thermodynamics and delta-Eddington shortwave beside BL99 and ccsm3:
    3 warm steps, 2 timed by phase, one counted in PyTorch operations; K1
    and K2 against their plain versions on the mushy, dEdd state (max abs
    error 0.0), timed; (b) gx1pop,evp1d,mushy,dedd for a day through the
    baseline runner with the conservation checks on each step and the
    ice salt budget; (c) three steps of gx1pop,evp1d alone and with each
    set of COLUMN_SETS (the second timed and its peak memory taken, the
    third's host reads counted)."""
    import shutil

    import torch

    from cice_tpu_torch import constants as cst
    from cice_tpu_torch import config as C
    from cice_tpu_torch.dynamics.evp import evp_solve
    from cice_tpu_torch.kernels import evp as kevp, remap as kremap
    from cice_tpu_torch.measure import (bound_ms, count_host_reads,
                                        count_ops, evp_state_problem,
                                        timed_ms, transport_state_problem)
    from cice_tpu_torch.model.diagnostics import (check_state,
                                                  hemispheric_budgets,
                                                  runtime_diags)
    from cice_tpu_torch.model.driver import Model

    out = {}
    k12 = lambda n: {"evp_fused": n, "transport_fused": n,
                     "tracer_fluxes": 0}

    # ---- (a) the step with mushy + dEdd beside BL99 + ccsm3 -------------
    def timed_steps(cfg, what):
        m = Model(cfg, device=dev)
        m.run(3)
        timer = PhaseTimer()
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.run(2, timer=timer)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 2
        launches = read_counters()
        phase = {k: v / 2 for k, v in timer.totals().items()}
        ops = count_ops(lambda: m.step())
        reads = count_host_reads(lambda: m.step())
        torch.cuda.synchronize()
        print(f"{what} at gx1pop (320x384, f32, K1 + K2) on {smi}: "
              f"{step_ms:.3f} ms per step (host clock, 2 steps after 3), "
              f"{ops} PyTorch operations and {reads} host reads per step, "
              f"launches {launches}; "
              "phases by CUDA events (ms per step): "
              + ", ".join(f"{k} {v:.3f}" for k, v in phase.items()))
        if launches != k12(2):
            fail(f"{what}: launches {launches}, expected {k12(2)}")
        return m, dict(step_ms=step_ms, phase_ms=phase, ops=ops,
                       reads=reads, launches=launches)

    base_cfg = C.gx1pop_step(remap_kernel="auto")
    _, out["bl99_ccsm3"] = timed_steps(base_cfg, "BL99 + ccsm3")
    m, out["mushy_dedd"] = timed_steps(base_cfg.with_overrides(**MUSHY_DEDD),
                                       "mushy + dEdd")
    dt = m.cfg.setup.dt
    args, kw = evp_state_problem(m.static, m.grid, m.state, m.forcing,
                                 m.flux.strairx, m.flux.strairy, dt)
    ref = evp_solve(*args, **kw)
    got = kevp.evp_solve_fused(*args, **kw)
    targs, moving = transport_state_problem(m.static, m.grid, m.state, dt)
    ref2 = kremap.transport_plain(*targs)
    got2 = kremap.transport_fused(*targs)
    torch.cuda.synchronize()
    err = lambda g_, r_: max(float((a - b).abs().max())
                             for a, b in zip(g_, r_))
    k1_err, k2_err = err(got, ref), err(got2, ref2)
    speed = float(torch.sqrt(ref[0] ** 2 + ref[1] ** 2).max())
    table = targs[-1]
    print(f"K1 and K2 on the mushy, dEdd state at gx1pop: max |u,v| "
          f"{speed:.3e} m/s, max departure {moving:.3e} cells, NT="
          f"{len(table)} ({', '.join(sorted({t.name for t in table}))}); "
          f"K1 max abs error {k1_err} against evp_solve, K2 {k2_err} "
          "against transport_plain")
    if not (speed > 1e-3 and moving > 1e-4 and k1_err == 0.0
            and k2_err == 0.0):
        fail("K1 or K2 differs from its plain version on the mushy, dEdd "
             "state")
    ny, nx = m.grid.shape
    ncat = targs[3].shape[0] - 1
    active, needed = kremap.work_fractions(*targs[:3])
    k2 = dict(ms=timed_ms(lambda: kremap.transport_fused(*targs), 10),
              plain_ms=timed_ms(lambda: kremap.transport_plain(*targs), 3),
              bound=bound_ms(*kremap.bound_bytes_flops(
                  table, ncat, ny, nx, active, needed)), err=k2_err)
    k1 = dict(ms=timed_ms(lambda: kevp.evp_solve_fused(*args, **kw), 5),
              plain_ms=timed_ms(lambda: evp_solve(*args, **kw), 2),
              bound=bound_ms(*kevp.bound_bytes_flops(ny, nx,
                                                     args[1].ndte)),
              err=k1_err)
    for nm, k in (("K1", k1), ("K2", k2)):
        print(f"{nm} on the mushy, dEdd state: kernel {k['ms']:.4f} ms, "
              f"plain {k['plain_ms']:.3f} ms per call; bound "
              f"{k['bound'][0]:.4f} ms by {k['bound'][1]}")
    out.update(k1=k1, k2=k2, k2_active=active, k2_needed=needed,
               nt=len(table))
    del m, args, kw, targs, ref, got, ref2, got2

    cfg_for, run = baseline_runner(dev, smi, reset_counters, read_counters)
    try:
        # ---- (b) one day of gx1pop,evp1d,mushy,dedd ---------------------
        # the budgets from the state before and after each step (Model's
        # own conservation check would stop the run at the exact remap's
        # known -7.7e-11 ice-edge cell, ROADMAP section C; the transport
        # checks are kept and the negative depth bounded, as in phase 5)
        rec = dict(salt=[], fsalt=[], water=[], area=[], neg=[], sice=[],
                   prev=None)

        def budgets(bm):
            g = bm.grid
            w = (g.tarea * g.hm).double()
            st = bm.state
            rec["salt"].append(float(torch.sum(
                cst.rhoi * 1e-3 * (st.trcrn["sice"].double().mean(1) *
                                   st.vicen.double()).sum(0) * w)))
            rec["fsalt"].append(float(torch.sum(bm.flux.fsalt.double() * w))
                                * bm.cfg.setup.dt)
            if rec["prev"] is not None:
                b = hemispheric_budgets(
                    g, rec["prev"], st, bm.flux, bm.forcing,
                    bm.cfg.setup.dt,
                    frazil_in_fresh=bm.cfg.forcing.update_ocn_f,
                    pond_lvl=bm.cfg.tracers.tr_pond_lvl)
                rec["water"].append(abs(float(b["water_residual"])) / max(
                    abs(float(b["dM"])), abs(float(b["water_in"])), 1.0))
            rec["prev"] = st
            rec["area"].append(float(bm.tchecks["cons_err_area"]))
            rec["neg"].append(float(bm.tchecks["neg_mass_depth"]))
            rec["sice"].append((float(st.trcrn["sice"].min()),
                                float(st.trcrn["sice"].max())))

        day = run("gx1pop,evp1d,mushy,dedd", "gx1pop+mushy+dedd",
                  ["setup.npt=1", "setup.conserv_check=true",
                   "setup.diagfreq=0"], k12(24), each_step=budgets)
        rec.pop("prev")
        # the ice salt change against the salt flux to the ocean over
        # steps 2..24 (the flux of a step leaves during that step)
        dsalt = rec["salt"][-1] - rec["salt"][0]
        out_salt = sum(rec["fsalt"][1:])
        resid = dsalt + out_salt
        smin = min(x for x, _ in rec["sice"])
        smax = max(x for _, x in rec["sice"])
        print(f"gx1pop,evp1d,mushy,dedd for a day on {smi}: freshwater "
              f"residual / budget at most {max(rec['water']):.3e} (1 % "
              f"rule), transport area error at most {max(rec['area']):.3e}"
              f" (1e-5), negative mass before the floor at most "
              f"{max(rec['neg']):.3e} deep (1e-9); ice salt "
              f"{rec['salt'][0]:.6e} -> {rec['salt'][-1]:.6e} kg, salt to "
              "the ocean "
              f"{out_salt:.6e} kg, residual {resid:.3e} kg "
              f"({resid / max(abs(dsalt), 1.0):.3e} of the change; "
              "saltflux_option='constant' books melt and growth at "
              f"ice_ref_salinity); sice in [{smin:.3f}, {smax:.3f}] g/kg")
        if not (max(rec["water"]) <= 1e-2 and max(rec["area"]) <= 1e-5
                and max(rec["neg"]) <= 1e-9
                and all(map(math.isfinite, rec["salt"] + rec["fsalt"]))
                and 0.0 <= smin and smax <= 200.0):
            fail("gx1pop,evp1d,mushy,dedd: a budget or a salinity is off")
        out["day"] = dict(day, water_max=max(rec["water"]),
                          area_max=max(rec["area"]),
                          neg_mass_depth_max=max(rec["neg"]),
                          salt_change=dsalt,
                          salt_to_ocean=out_salt, salt_residual=resid,
                          sice_range=(smin, smax))
        # ---- (c) three steps of each other option set -------------------
        # gx1pop,evp1d alone first: the reference for the peak memory and
        # the host reads of the sets
        out["sets"] = {}
        for opt in ("",) + COLUMN_SETS:
            label = f"gx1pop_evp1d_{opt or 'alone'}"
            sm = Model(cfg_for("gx1pop,evp1d" + (f",{opt}" if opt else ""),
                               label, []), device=dev)
            gc.collect()
            reset_counters()
            sm.step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            sm.step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak_mb = (torch.cuda.max_memory_allocated() - held) / 1e6
            launches = read_counters()
            reads = count_host_reads(lambda: sm.step())
            st = sm.state
            fin = all(bool(torch.isfinite(t).all()) for t in (
                st.aicen, st.vicen, st.vsnon, st.uvel, st.vvel, st.sst,
                *st.trcrn.values()))
            d = {k: float(v) for k, v in runtime_diags(sm.grid, st).items()}
            cs = {k: float(v) for k, v in check_state(st).items()}
            ok = (fin and d["aice_max"] <= 1.0 + 1e-6 and d["extent_nh"] > 0
                  and d["extent_sh"] > 0 and not cs["unstable"]
                  and not cs["nonfinite"] and launches == k12(2))
            print(f"gx1pop,evp1d{',' + opt if opt else ''} on {smi}: "
                  f"{ms:.1f} ms for the second"
                  f" step (host clock), {peak_mb:.1f} MB allocated above "
                  f"the state at its peak, {reads} host reads in the third,"
                  f" launches {launches}, finite {fin}, "
                  f"aice max {d['aice_max']:.4f}, extent nh "
                  f"{d['extent_nh']:.3e} sh {d['extent_sh']:.3e}, "
                  f"check_state {cs}: {'PASS' if ok else 'FAIL'}")
            if not ok:
                fail(f"gx1pop,evp1d,{opt}: the oracle failed")
            out["sets"][opt or "alone"] = dict(ms=ms, peak_mb=peak_mb,
                                               reads=reads,
                                               launches=launches)
            del sm
    finally:
        shutil.rmtree(BASELINE_ROOT, ignore_errors=True)
    return out


#: the biogeochemical option sets of phase 12 (b), on top of gx1pop,evp1d
#: ('forcing.highfreq=true' rides as a --set)
BGC_SETS = ("aerosol", "isotope", "modal", "bgcskl", "bgcz", "zaero",
            "alt03", "alt04", "forcing.highfreq=true")


def _exact(got, ref) -> float:
    """Max abs difference over paired outputs (NaN if any side is NaN)."""
    import torch
    err = 0.0
    for g, r in zip(got, ref):
        if g.shape != r.shape:
            return float("nan")
        d = (g - r).abs()
        if not bool(torch.isfinite(d).all()):
            return float("nan")
        err = max(err, float(d.max()))
    return err


def biogeochemistry(dev, smi, reset_counters, read_counters):
    """Phase 12: the biogeochemistry at gx1pop's full width. (a) K1, K2
    and K3 against their plain versions on the bgcz state (NT=266) after 3
    steps of gx1pop_step('auto') with bgcz (K1 + K2; the last two timed by
    phase, with each phase's peak memory), max abs error 0.0,
    each timed beside its bound; then one step of gx1pop_step (K1 + K3)
    from that state; (b) three steps of gx1pop,evp1d with each set of
    BGC_SETS; (c) a day of gx1pop,evp1d,bgcz through the baseline runner
    and 24 steps of gx1pop,evp1d,aerosol, each with the budgets on every
    step and the inventory change of a tracer beside its sources and
    sinks (report-only)."""
    import shutil

    import torch

    from cice_tpu_torch import config as C
    from cice_tpu_torch.cli.main import OPTION_SETS
    from cice_tpu_torch.columns.aero_iso import FAERO_DEFAULT
    from cice_tpu_torch.dynamics.evp import evp_solve
    from cice_tpu_torch.kernels import evp as kevp, remap as kremap
    from cice_tpu_torch.measure import (bound_ms, count_host_reads,
                                        count_ops, evp_state_problem,
                                        flux_case, timed_ms,
                                        transport_state_problem)
    from cice_tpu_torch.model.diagnostics import (check_state,
                                                  hemispheric_budgets,
                                                  runtime_diags)
    from cice_tpu_torch.model.driver import Model

    out = {}
    bgcz = dict(OPTION_SETS["bgcz"])

    # ---- (a) the kernels on the bgcz state -----------------------------
    m = Model(C.gx1pop_step(remap_kernel="auto").with_overrides(**bgcz),
              device=dev)
    timer = PhaseTimer()
    reset_counters()
    m.run(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.run(2, timer=timer)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 2
    launches_auto = read_counters()
    phase = {k: v / 2 for k, v in timer.totals().items()}
    print(f"bgcz at gx1pop (320x384, f32, K1 + K2, box2001) on {smi}: "
          f"{step_ms:.3f} ms per step (host clock, steps 2 and 3); phases "
          "by CUDA events (ms per step, MB allocated above the phase's "
          "start at its peak): " + ", ".join(
              f"{k} {v:.3f} ({timer.peak_mb[k]:.0f} MB)"
              for k, v in phase.items()))
    if launches_auto != {"evp_fused": 3, "transport_fused": 3,
                         "tracer_fluxes": 0}:
        fail(f"bgcz, 3 steps through K1 + K2: launches {launches_auto}")
    dt = m.cfg.setup.dt
    ny, nx = m.grid.shape
    args, kw = evp_state_problem(m.static, m.grid, m.state, m.forcing,
                                 m.flux.strairx, m.flux.strairy, dt)
    k1_err = _exact(kevp.evp_solve_fused(*args, **kw), evp_solve(*args, **kw))
    targs, moving = transport_state_problem(m.static, m.grid, m.state, dt)
    table = targs[-1]
    ncat = targs[3].shape[0] - 1
    k2_err = _exact(kremap.transport_fused(*targs),
                    kremap.transport_plain(*targs))
    fargs, tstack = flux_case(*targs)
    k3_err = _exact(kremap.tracer_fluxes_fused(*fargs, tstack=tstack),
                    kremap.tracer_fluxes_plain(*fargs))
    torch.cuda.synchronize()
    types = [t.ttype for t in table]
    z = m.state.trcrn
    nit_range = (float(z["bgc_Nit"].min()), float(z["bgc_Nit"].max()))
    print(f"K1, K2 and K3 on the bgcz state at gx1pop (3 steps, K1 + K2): "
          f"NT={len(table)} ({types.count(1)} of type 1, {types.count(2)} "
          f"of type 2, {types.count(3)} of type 3), max departure "
          f"{moving:.3e} cells, bgc_Nit in [{nit_range[0]:.4f}, "
          f"{nit_range[1]:.4f}]; max abs error K1 {k1_err} against "
          f"evp_solve, K2 {k2_err} against transport_plain, K3 {k3_err} "
          "against tracer_fluxes_plain")
    if not (k1_err == 0.0 and k2_err == 0.0 and k3_err == 0.0
            and moving > 1e-4 and len(table) == 266):
        fail("a kernel differs from its plain version on the bgcz state")
    active, needed = kremap.work_fractions(*targs[:3])
    k2i = kremap.kernel_info(table)
    kern = {
        "K1": dict(ms=timed_ms(lambda: kevp.evp_solve_fused(*args, **kw), 5),
                   plain_ms=timed_ms(lambda: evp_solve(*args, **kw), 2),
                   bound=bound_ms(*kevp.bound_bytes_flops(
                       ny, nx, args[1].ndte)), err=k1_err),
        "K2": dict(ms=timed_ms(lambda: kremap.transport_fused(*targs), 5),
                   plain_ms=timed_ms(lambda: kremap.transport_plain(*targs),
                                     2),
                   bound=bound_ms(*kremap.bound_bytes_flops(
                       table, ncat, ny, nx, active, needed)), err=k2_err,
                   chunks=k2i["chunks"], chunk=k2i["chunk"],
                   smem=k2i["smem"], tile=k2i["tile"]),
        "K3": dict(ms=timed_ms(lambda: kremap.tracer_fluxes_fused(
                       *fargs, tstack=tstack), 5),
                   plain_ms=timed_ms(lambda: kremap.tracer_fluxes_plain(
                       *fargs), 2),
                   bound=bound_ms(*kremap.tracer_fluxes_bound_bytes_flops(
                       table, ncat, ny, nx, active, needed)), err=k3_err,
                   tstack_mb=tstack.numel() * tstack.element_size() / 1e6),
    }
    for nm, k in kern.items():
        print(f"{nm} on the bgcz state on {smi}: kernel {k['ms']:.4f} ms, "
              f"plain {k['plain_ms']:.3f} ms per call; bound "
              f"{k['bound'][0]:.4f} ms by {k['bound'][1]}"
              + (f"; {k['chunks']} tracer chunks of up to {k['chunk']} "
                 f"reconstructions, tile {k['tile'][0]}x{k['tile'][1]}, "
                 f"{k['smem']} B shared memory per block" if nm == "K2"
                 else "")
              + (f"; tstack {k['tstack_mb']:.1f} MB" if nm == "K3" else ""))
    out.update(kernels=kern, active=active, needed=needed, nt=len(table),
               launches_auto=launches_auto, step_ms=step_ms, phase_ms=phase,
               phase_peak_mb=timer.peak_mb)
    del args, kw, targs, fargs, tstack
    # one step of gx1pop_step (K1 + K3) from the bgcz state
    m3 = Model(C.gx1pop_step().with_overrides(**bgcz), device=dev)
    m3.state, m3.calendar = m.state, m.calendar
    del m
    reset_counters()
    m3.step()
    torch.cuda.synchronize()
    out["launches_k3"] = read_counters()
    tc = {k: float(v) for k, v in m3.tchecks.items()}
    fin = all(bool(torch.isfinite(t).all()) for t in m3.state.trcrn.values())
    print(f"one step of gx1pop_step (K1 + K3) with bgcz from that state: "
          f"launches {out['launches_k3']}, finite {fin}, checks {tc}")
    if out["launches_k3"] != {"evp_fused": 1, "transport_fused": 0,
                              "tracer_fluxes": 1} or not fin or tc["oob"]:
        fail("bgcz through K1 + K3 failed")
    del m3
    gc.collect()
    torch.cuda.empty_cache()

    cfg_for, run = baseline_runner(dev, smi, reset_counters, read_counters)
    try:
        # ---- (b) three steps of gx1pop,evp1d with each set --------------
        out["sets"] = {}
        for opt in BGC_SETS:
            is_set = "=" not in opt
            opts = "gx1pop,evp1d" + (f",{opt}" if is_set else "")
            label = "gx1pop_evp1d_" + (opt if is_set else "highfreq")
            sm = Model(cfg_for(opts, label, [] if is_set else [opt]),
                       device=dev)
            d_ = sm.cfg.dynamics
            per_step = {"evp_fused": int(d_.kdyn == 1 and
                                         d_.evp_algorithm == "fused_pallas"),
                        "transport_fused": int(d_.advection == "remap"),
                        "tracer_fluxes": 0}
            gc.collect()
            reset_counters()
            sm.step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            sm.step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak_mb = (torch.cuda.max_memory_allocated() - held) / 1e6
            reads = []
            ops = count_ops(lambda: reads.append(count_host_reads(sm.step)))
            torch.cuda.synchronize()
            launches = read_counters()
            st = sm.state
            fin = all(bool(torch.isfinite(t).all()) for t in (
                st.aicen, st.vicen, st.vsnon, st.uvel, st.vvel, st.sst,
                *st.trcrn.values()))
            d = {k: float(v) for k, v in runtime_diags(sm.grid, st).items()}
            cs = {k: float(v) for k, v in check_state(st).items()}
            expect = {k: 3 * v for k, v in per_step.items()}
            ok = (fin and d["aice_max"] <= 1.0 + 1e-6 and d["extent_nh"] > 0
                  and d["extent_sh"] > 0 and not cs["unstable"]
                  and not cs["nonfinite"] and launches == expect)
            print(f"{opts}{'' if is_set else ' ' + opt} on {smi}: "
                  f"{ms:.1f} ms for the second step (host clock), "
                  f"{peak_mb:.1f} MB allocated above the state at its peak, "
                  f"{ops} PyTorch operations and {reads[0]} host reads in "
                  f"the third, NT {len(st.trcrn)} registry tracers, "
                  f"launches {launches} (expected {expect}), finite {fin}, "
                  f"aice max {d['aice_max']:.4f}, extent nh "
                  f"{d['extent_nh']:.3e} sh {d['extent_sh']:.3e}, "
                  f"check_state {cs}: {'PASS' if ok else 'FAIL'}")
            if not ok:
                fail(f"{opts} {opt}: the oracle failed")
            out["sets"][label] = dict(ms=ms, peak_mb=peak_mb, ops=ops,
                                      reads=reads[0], launches=launches)
            del sm

        # ---- (c) a day of bgcz, 24 steps of aerosol ---------------------
        def recorder(inventory, sources):
            """each_step callback: the freshwater and area checks of the
            step, and the tracer inventory and its sources (kg or mmol)
            accumulated over the steps."""
            rec = dict(water=[], area=[], neg=[], inv=[], src=0.0,
                       prev=None)

            def each(bm):
                g = bm.grid
                st = bm.state
                w = (g.tarea * g.hm).double()
                if rec["prev"] is not None:
                    b = hemispheric_budgets(
                        g, rec["prev"], st, bm.flux, bm.forcing,
                        bm.cfg.setup.dt,
                        frazil_in_fresh=bm.cfg.forcing.update_ocn_f,
                        pond_lvl=bm.cfg.tracers.tr_pond_lvl)
                    rec["water"].append(abs(float(b["water_residual"])) /
                                        max(abs(float(b["dM"])),
                                            abs(float(b["water_in"])), 1.0))
                rec["prev"] = st
                rec["area"].append(float(bm.tchecks["cons_err_area"]))
                rec["neg"].append(float(bm.tchecks["neg_mass_depth"]))
                rec["inv"].append(float(torch.sum(inventory(st) * w)))
                rec["src"] += float(torch.sum(sources(bm) * w)) * \
                    bm.cfg.setup.dt
            return rec, each

        def nitrate(st):
            # content per layer = C * vicen * fbri / nblyr
            return (st.trcrn["bgc_Nit"].double().mean(1) *
                    st.vicen.double() * st.trcrn["fbri"].double()).sum(0)

        def nitrate_src(bm):
            # no deposition of nitrate; the flux to the ocean leaves
            return -bm.flux.ncat_fluxes["fzbgc_bgc_Nit"].double()

        def aerosol1(st):
            a = st.trcrn["aerosno"][:, :2] + st.trcrn["aeroice"][:, :2]
            return (a.double().sum(1) * st.aicen.double()).sum(0)

        def aerosol1_src(bm):
            # deposition where there is ice, less the flux to the ocean
            st = bm.state
            ice = (st.aicen > 1e-11).double() * st.aicen.double()
            return ice.sum(0) * FAERO_DEFAULT[0] - \
                bm.flux.ncat_fluxes["faero_ocn"][0].double()

        def report(what, rec, day):
            rec.pop("prev")
            change = rec["inv"][-1] - rec["inv"][0]
            print(f"{what} on {smi}: freshwater residual / budget at most "
                  f"{max(rec['water']):.3e} (1 % rule), transport area "
                  f"error at most {max(rec['area']):.3e} (1e-5), negative "
                  f"mass before the floor at most {max(rec['neg']):.3e} "
                  f"deep (1e-9); inventory {rec['inv'][0]:.6e} -> "
                  f"{rec['inv'][-1]:.6e} (change {change:.6e}), sources "
                  f"less sinks over the steps {rec['src']:.6e}, residual "
                  f"{change - rec['src']:.3e} (report-only: in-ice "
                  "reactions, ridging and zapped ice move it too)")
            if not (max(rec["water"]) <= 1e-2 and max(rec["area"]) <= 1e-5
                    and max(rec["neg"]) <= 1e-9
                    and all(map(math.isfinite, rec["inv"]))):
                fail(f"{what}: a budget is off")
            return dict(day or {}, water_max=max(rec["water"]),
                        area_max=max(rec["area"]),
                        neg_mass_depth_max=max(rec["neg"]),
                        inventory=(rec["inv"][0], rec["inv"][-1]),
                        sources=rec["src"], residual=change - rec["src"])

        rec, each = recorder(nitrate, nitrate_src)
        day = run("gx1pop,evp1d,bgcz", "gx1pop+bgcz",
                  ["setup.npt=1", "setup.conserv_check=true",
                   "setup.diagfreq=0"],
                  {"evp_fused": 24, "transport_fused": 24,
                   "tracer_fluxes": 0}, each_step=each)
        out["bgcz_day"] = report("gx1pop,evp1d,bgcz for a day: nitrate", rec,
                                 day)
        am = Model(cfg_for("gx1pop,evp1d,aerosol", "gx1pop+aerosol",
                           ["setup.conserv_check=true", "setup.diagfreq=0"]),
                   device=dev)
        rec, each = recorder(aerosol1, aerosol1_src)
        reset_counters()
        for _ in range(24):
            am.step()
            each(am)
        launches = read_counters()
        if launches != {"evp_fused": 24, "transport_fused": 24,
                        "tracer_fluxes": 0}:
            fail(f"gx1pop,evp1d,aerosol: launches {launches}")
        out["aerosol_day"] = report(
            "gx1pop,evp1d,aerosol for 24 steps: aerosol species 1", rec,
            dict(launches=launches))
        del am
    finally:
        shutil.rmtree(BASELINE_ROOT, ignore_errors=True)
    return out


A7_ROOT = os.path.join(HERE, "cice_tpu_torch", "_build", "smoke_a7")


def _sha(path) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def coupling_and_io(dev, smi, reset_counters, read_counters) -> dict:
    """Phase 13: coupling and I/O at gx1pop's full width. (a) the
    background writer: gx1pop,evp1d for a day with io_async off and on,
    equal states and byte-identical files, the pointer never ahead of its
    file, the file step split into serialisation and write; (b) the
    coupler: 6 steps of CoupledIce on a standalone Model's forcing, each
    equal to model_step on the imported Forcing, a seventh with Sa_tbot
    changed, the exports; (c) gx1pop,prescribed for a day; (d)
    gx1pop,evp1d,bdyrestore for a day, one step checked against model_step
    and the nudge; (e) the gx1 fixture as pop_bin, pop_nc and MOM grids, a
    step on pop_nc against pop_bin; (f) the perf sweep through K1, stream
    K1 against evp_solve at 768x640; (g) gx1pop,evp1d,bigdiag for a day,
    host reads per diagnostics record. Files go to A7_ROOT and are
    removed."""
    import argparse
    import contextlib
    import io as _io
    import shutil
    import statistics

    import numpy as np
    import torch

    from cice_tpu_torch import convert
    from cice_tpu_torch.cli import main as cli, perf as tperf
    from cice_tpu_torch.core.grid import GRID_FIELDS
    from cice_tpu_torch.dynamics.evp import evp_solve
    from cice_tpu_torch.io import fixtures as tfix, grids as tgrids
    from cice_tpu_torch.io import history as thist, restart as trst
    from cice_tpu_torch.kernels import evp as kevp
    from cice_tpu_torch.measure import count_host_reads
    from cice_tpu_torch.model import diagnostics as tdiag
    from cice_tpu_torch.model import prescribed as tpres
    from cice_tpu_torch.model.coupling import IMPORT_MAP, CoupledIce
    from cice_tpu_torch.model.driver import Model
    from cice_tpu_torch.model.restoring import boundary_zone_weight
    from cice_tpu_torch.model.state import state_leaves
    from cice_tpu_torch.model.step import model_step

    shutil.rmtree(A7_ROOT, ignore_errors=True)
    k12 = lambda n: {"evp_fused": n, "transport_fused": n,
                     "tracer_fluxes": 0}
    none = k12(0)
    out = {}

    def cfg_for(opts, label, *sets):
        d = os.path.join(A7_ROOT, label)
        return cli.build_config(argparse.Namespace(opts=opts, set=[
            f"setup.history_dir={d}/history/",
            f"setup.restart_dir={d}/restart/",
            f"setup.pointer_file={d}/restart/ice.restart_file", *sets]))

    def sync_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, r

    def same_state(x, y, what):
        for i, (a, b) in enumerate(zip(state_leaves(x), state_leaves(y))):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"{what}: leaf_{i} differs")

    try:
        # ---- (a) the background writer ---------------------------------
        # off, on, on, off: each mode twice, in turns on one card
        runs = []
        wb_ms: list = []
        saved = (trst.write_bytes, thist.write_bytes)

        def timed_write_bytes(*a, **k):
            t = time.perf_counter()
            saved[0](*a, **k)
            wb_ms.append((time.perf_counter() - t) * 1e3)
        trst.write_bytes = thist.write_bytes = timed_write_bytes
        try:
            for label, on in (("off1", False), ("on1", True), ("on2", True),
                              ("off2", False)):
                m = Model(cfg_for("gx1pop,evp1d", label, "setup.npt=1",
                                  f"setup.io_async={str(on).lower()}"),
                          device=dev, enable_history=True)
                if (m.io_writer is not None) != on or \
                        (on and not m.io_writer.native):
                    fail(f"writer {label}: io_writer {m.io_writer}")
                calls = []
                for nm, obj in (("restart", m), ("history", m.history)):
                    fn = getattr(obj, "write_restart" if nm == "restart"
                                 else "write_stream")

                    def wrapped(*a, _fn=fn, _nm=nm, **k):
                        n0 = len(wb_ms)
                        t = time.perf_counter()
                        r = _fn(*a, **k)
                        calls.append((_nm, (time.perf_counter() - t) * 1e3,
                                      sum(wb_ms[n0:])))
                        return r
                    setattr(obj, "write_restart" if nm == "restart"
                            else "write_stream", wrapped)
                ptr = m.cfg.setup.pointer_file
                steps, named = [], set()

                def chase():
                    """The pointer, where there is one, names a file on
                    disk."""
                    if os.path.exists(ptr):
                        with open(ptr) as f:
                            p = f.read().strip()
                        if not os.path.exists(p):
                            fail(f"writer {label}: the pointer names {p}, "
                                 "which is not on disk")
                        named.add(os.path.basename(p))
                reset_counters()
                for _ in range(24):
                    n = len(calls)
                    ms, _ = sync_ms(m.step)
                    steps.append((ms, len(calls) > n))
                    chase()
                launches = read_counters()
                flush_ms, errs = sync_ms(m.flush_io)
                chase()
                if launches != k12(24) or errs:
                    fail(f"writer {label}: launches {launches}, flush "
                         f"errors {errs}")
                busy = [x for x, w in steps if w]
                d = os.path.join(A7_ROOT, label)
                files = {}
                for sub in ("history", "restart"):
                    for f_ in sorted(os.listdir(os.path.join(d, sub))):
                        if f_ != "ice.restart_file":
                            files[f"{sub}/{f_}"] = _sha(
                                os.path.join(d, sub, f_))
                run = dict(
                    label=label, on=on, files=files, named=sorted(named),
                    launches=launches,
                    quiet_ms=statistics.median(x for x, w in steps if not w),
                    file_step_ms=statistics.mean(busy), nfile_steps=len(busy),
                    serialise_ms={nm: sum(c - w for n_, c, w in calls
                                          if n_ == nm)
                                  for nm in ("restart", "history")},
                    write_ms={nm: sum(w for n_, c, w in calls if n_ == nm)
                              for nm in ("restart", "history")},
                    flush_ms=flush_ms)
                r1 = lambda d: {k: round(v, 1) for k, v in d.items()}
                print(f"writer {'on' if on else 'off'} ({label}; "
                      f"gx1pop,evp1d, 24 steps, daily cdf1 history and npz "
                      f"restart) on {smi}: quiet step {run['quiet_ms']:.1f} "
                      f"ms (median), file step {run['file_step_ms']:.1f} ms "
                      f"({len(busy)} step), serialisation ms "
                      f"{r1(run['serialise_ms'])}, "
                      + ("submit to the pool" if on else "inline write")
                      + f" ms {r1(run['write_ms'])}, "
                      f"flush at the end {flush_ms:.1f} ms; launches "
                      f"{launches}; the pointer named {sorted(named)}, each "
                      "on disk when read")
                if not runs:
                    first = [t.clone() for t in state_leaves(m.state)]
                else:
                    if files != runs[0]["files"] or \
                            run["named"] != runs[0]["named"] or \
                            len(files) != 2 or not run["named"]:
                        fail(f"writer {label}: files {files}, pointer "
                             f"{run['named']} against {runs[0]}")
                    for i_, (x, y) in enumerate(zip(state_leaves(m.state),
                                                    first)):
                        if not torch.equal(x, y):
                            fail(f"writer {label}: leaf_{i_} differs from "
                                 "the first run")
                runs.append(run)
                del m
                shutil.rmtree(d, ignore_errors=True)
        finally:
            trst.write_bytes, thist.write_bytes = saved
        print(f"writer on and off: final states equal bit for bit in all "
              f"{len(first)} leaves; the history and restart files "
              f"byte-identical ({sorted(runs[0]['files'])})")
        out["writer"] = runs
        del first
        shutil.rmtree(A7_ROOT, ignore_errors=True)

        # ---- (b) the coupler --------------------------------------------
        cfg_b = cfg_for("gx1pop,evp1d", "coupler")
        dt = cfg_b.setup.dt
        S = Model(cfg_b, device=dev)
        ice = CoupledIce(cfg_b, device=dev)
        names = [(c, a_) for c, a_ in IMPORT_MAP.items()
                 if a_ != "frzmlt_in"]
        step_ms, lau = [], []
        for k in range(7):
            S.forcing = S._forcing()
            fields = {c: getattr(S.forcing, a_) for c, a_ in names}
            if k == 6:            # a warmer atmosphere for the last step
                fields["Sa_tbot"] = fields["Sa_tbot"] + 1.0
            ice.import_fields(fields)
            used = ice.coupled_forcing()
            st0 = ice.model.state
            ref, _ = model_step(ice.model.static, ice.model.grid, st0, used,
                                dt)
            if k == 6:
                plain = S.forcing
                base, _ = model_step(ice.model.static, ice.model.grid, st0,
                                     used.replace(Tair=plain.Tair), dt)
            reset_counters()
            ms, _ = sync_ms(ice.step)
            lau.append(read_counters())
            step_ms.append(ms)
            same_state(ice.model.state, ref,
                       f"coupled step {k + 1} vs model_step on its imports")
            S.calendar = S.calendar.advance(dt)
        dtb = max(float((x - y).abs().max()) for x, y in zip(
            state_leaves(ice.model.state), state_leaves(base))
            if x.is_floating_point())
        if not dtb > 0:
            fail("a changed Sa_tbot left the coupled step unchanged")
        exp_ms, host = sync_ms(lambda: convert.exports_to_numpy(
            ice.export_fields()))
        ai = host["Si_ifrac"]
        if not all(np.isfinite(v).all() for v in host.values()) or \
                ai.min() < 0 or ai.max() > 1.0 + 1e-6 or \
                np.abs(host["Faii_sen"][ai <= 1e-11]).max() != 0.0:
            fail("the coupler's exports are not finite, in range and "
                 "zero without ice")
        if any(x != k12(1) for x in lau):
            fail(f"coupled steps: launches {lau}")
        out["coupler"] = dict(step_ms=step_ms, exports_ms=exp_ms,
                              nexports=len(host), launches=lau[0],
                              tbot_change=dtb)
        print(f"coupler (gx1pop,evp1d imports, 7 steps) on {smi}: each "
              f"step equals model_step on its imported Forcing bit for bit; "
              f"Sa_tbot + 1 K moves the state by up to {dtb:.3e}; coupled "
              f"step ms {[round(x, 1) for x in step_ms]}; {len(host)} "
              f"exports finite, Si_ifrac in [0, 1], scaled fluxes zero "
              f"without ice, to numpy in {exp_ms:.1f} ms; launches per step "
              f"{lau[0]}")
        del S, ice, ref, base, st0, used

        # ---- (c) prescribed ice -----------------------------------------
        cov_path = tfix.ensure_ice_cov("gx1")
        cfg_c = cfg_for("gx1pop,prescribed", "prescribed", "setup.npt=1",
                        "setup.conserv_check=true")
        mc = Model(cfg_c, device=dev)
        if mc._ice_cov is None:
            fail(f"prescribed: {cov_path} was not read")
        worst = []
        orig = tpres.prescribe_ice_state

        def checked(cfg, grid, state, data, hin_max):
            st = orig(cfg, grid, state, data, hin_max)
            want = torch.clamp(data.to(st.aicen.dtype), 0, 1) * grid.hm
            worst.append(float((st.aice - want).abs().max()))
            return st
        tpres.prescribe_ice_state = checked
        try:
            reset_counters()
            ms_c, _ = sync_ms(lambda: mc.run())
            lc = read_counters()
        finally:
            tpres.prescribe_ice_state = orig
        if lc != none or len(worst) != 24 or max(worst) != 0.0:
            fail(f"prescribed: launches {lc}, |aice - data*hm| {worst}")
        res = max(abs(r["bud_water_residual"]) / max(
            abs(r["bud_dM"]), abs(r["bud_water_in"]), 1.0)
            for r in mc.diag_log)
        out["prescribed"] = dict(steps=24, wall_ms=ms_c, launches=lc,
                                 records=len(mc.diag_log),
                                 water_residual_share=res)
        print(f"prescribed (gx1pop,prescribed, ice_cov.npz, 24 steps) on "
              f"{smi}: {ms_c:.0f} ms, aice = data x hm exactly after each "
              f"reset, no abort ({len(mc.diag_log)} conservation records, "
              f"freshwater residual up to {res:.3e} of the budget: the "
              f"reset moves mass with no flux); launches {lc}")
        del mc

        # ---- (d) restoring ----------------------------------------------
        cfg_d = cfg_for("gx1pop,evp1d,bdyrestore", "restoring",
                        "setup.npt=1")
        md = Model(cfg_d, device=dev)
        zone = boundary_zone_weight(md.grid)
        lau_d = []
        for k in range(24):
            if k == 12:
                fc = md._forcing()
                plain, _ = model_step(md.static, md.grid, md.state, fc, dt)
            reset_counters()
            md.step()
            lau_d.append(read_counters())
            if k == 12:
                rate = dt / (cfg_d.forcing.trestore * 86400.0)
                tgt = md._restore_target
                inside = zone > 0
                err = 0.0
                for nm in ("aicen", "vicen", "vsnon"):
                    p, t_, g = (getattr(plain, nm), tgt[nm],
                                getattr(md.state, nm))
                    err = max(err, float((g - (p + rate * zone *
                                                (t_ - p))).abs().max()))
                    if not torch.equal(g[:, ~inside], p[:, ~inside]):
                        fail(f"restoring: {nm} moved outside the zone")
                sst_err = float((md.state.sst - (plain.sst + rate * (
                    fc.sst_data - plain.sst))).abs().max())
                moved = float((md.state.aicen - plain.aicen).abs().max())
                if err != 0.0 or sst_err != 0.0 or not moved > 0:
                    fail(f"restoring: nudge error {err}, sst {sst_err}, "
                         f"moved {moved}")
        if any(x != k12(1) for x in lau_d):
            fail(f"restoring: launches {lau_d}")
        cs = {k: float(v) for k, v in tdiag.check_state(md.state).items()}
        if cs["nonfinite"]:
            fail(f"restoring: check_state {cs}")
        out["restoring"] = dict(launches=lau_d[0], zone_cells=int(
            (zone > 0).sum()), moved=moved)
        print(f"restoring (gx1pop,evp1d,bdyrestore, 24 steps) on {smi}: "
              f"step 13 equals model_step then the nudge bit for bit (zone "
              f"{int((zone > 0).sum())} cells, 3 rows at the open edges, "
              f"aicen moved up to {moved:.3e}; outside untouched; SST "
              f"relaxed); no abort; launches per step {lau_d[0]}")
        del md, plain, fc

        # ---- (e) grids ---------------------------------------------------
        forms = tfix.ensure_grid_forms("gx1")
        base = cfg_for("gx1pop,evp1d", "grids")
        fmts = {"pop_bin": {},
                "pop_nc": {"grid.grid_format": "pop_nc",
                           "grid.grid_file": forms["pop_nc"],
                           "grid.kmt_file": ""},
                "mom": {"grid.grid_format": "mom",
                        "grid.grid_file": forms["mom"],
                        "grid.kmt_file": forms["mask"]}}
        load_ms, grids = {}, {}
        for f_, over in fmts.items():
            load_ms[f_], grids[f_] = sync_ms(lambda: tgrids.load_grid_files(
                base.with_overrides(**over), device=dev))
        mom_ulp = 0.0
        for k in GRID_FIELDS:
            a_, b_, c_ = (getattr(grids[f_], k) for f_ in fmts)
            if not torch.equal(a_, b_):
                fail(f"grids: pop_nc differs from pop_bin in {k}")
            if k in ("ULAT", "ULON", "TLAT", "TLON", "ANGLE", "ANGLET"):
                # through degrees: within 4 ulp of the field's largest value
                ulp = float((a_ - c_).abs().max()) / (
                    torch.finfo(a_.dtype).eps * float(a_.abs().max()))
                mom_ulp = max(mom_ulp, ulp)
                if ulp > 4:
                    fail(f"grids: MOM {k} {ulp} ulp from pop_bin")
            elif not torch.equal(a_, c_):
                fail(f"grids: MOM differs from pop_bin in {k}")
        steps_e, lau_e = {}, {}
        for f_ in ("pop_bin", "pop_nc"):
            me = Model(base.with_overrides(**fmts[f_]), device=dev)
            reset_counters()
            me.step()
            lau_e[f_] = read_counters()
            steps_e[f_] = me.state
        same_state(steps_e["pop_nc"], steps_e["pop_bin"],
                   "a gx1pop,evp1d step on the pop_nc grid vs pop_bin")
        if any(x != k12(1) for x in lau_e.values()):
            fail(f"grids: launches {lau_e}")
        out["grids"] = dict(load_ms=load_ms, mom_max_ulp=mom_ulp,
                            launches=lau_e["pop_nc"])
        print(f"grids (gx1 fixture, 320x384) on {smi}: pop_nc equals "
              f"pop_bin bit for bit in all {len(GRID_FIELDS)} fields, MOM "
              f"equal in the metrics and within {mom_ulp:.2f} ulp (gate 4) "
              f"in lat/lon/angle; a gx1pop,evp1d step on pop_nc equals "
              f"pop_bin's bit for bit; load ms {load_ms}; launches "
              f"{lau_e['pop_nc']}")
        del grids, steps_e, me

        # ---- (f) perf -----------------------------------------------------
        rows = tperf.run_perf(sizes=((192, 160), (384, 320), (768, 640)),
                              ndte=120, out=lambda s: None, device=dev)
        routes = [r["route"] for r in rows[:3]]
        if routes != ["persistent", "persistent", "stream"]:
            fail(f"perf: K1 routes {routes}")
        args, kw = tperf._setup(768, 640, 120, dev)
        kevp.stream_launches = 0
        got = kevp.evp_solve_fused(*args, **kw)
        ref = evp_solve(*args, **kw)
        torch.cuda.synchronize()
        if kevp.stream_launches != 1:
            fail("perf: K1 at 768x640 did not take the stream route")
        perf_err = _exact(got, ref)
        speed = float(torch.sqrt(ref[0] ** 2 + ref[1] ** 2).max())
        if perf_err != 0.0 or not speed > 0:
            fail(f"perf: stream K1 at 768x640 against evp_solve: max abs "
                 f"error {perf_err}, max speed {speed}")
        reset_counters()
        out["perf"] = dict(rows=rows, stream_max_abs_err=perf_err)
        for r in rows:
            print(f"perf {r['sweep']} {r['grid']} (ndte 120) on {smi}: "
                  f"route {r['route']}, {r['s_per_dynstep'] * 1e3:.3f} ms "
                  f"per solve (host clock, best of 5), {r['Mptsub_s']:.1f} "
                  "Mpt*subcycles/s")
        print(f"perf: stream K1 at 768x640 equals evp_solve, max abs error "
              f"{perf_err} over its nine outputs")
        del args, kw, got, ref

        # ---- (g) probes ----------------------------------------------------
        def probe_day(opts, label, *sets):
            mg = Model(cfg_for(opts, label, "setup.npt=1", *sets),
                       device=dev)
            reads, lau_g = [], []
            buf = _io.StringIO()
            with contextlib.redirect_stdout(buf):
                for _ in range(24):
                    reset_counters()
                    reads.append((count_host_reads(mg.step),
                                  mg.calendar.istep % mg.cfg.setup.diagfreq
                                  == 0))
                    lau_g.append(read_counters())
            return mg, reads, lau_g, buf.getvalue()

        try:
            mg, reads, lau_g, dump = probe_day("gx1pop,evp1d,bigdiag",
                                               "probes")
            ran = "gx1pop,evp1d,bigdiag"
        except RuntimeError as e:
            if not str(e).endswith(": negative mass after remap (early "
                                   "checkpoint written)"):
                raise
            # the exact remap's known ice-edge cell (ROADMAP section C):
            # bigdiag's conservation checks abort there; the probes run
            # without them
            print(f"probes: gx1pop,evp1d,bigdiag aborts on the known "
                  f"ice-edge cell of the exact remap: {e}")
            mg, reads, lau_g, dump = probe_day(
                "gx1pop,evp1d,diagpt1", "probes2", "setup.debug_model=true")
            ran = "gx1pop,evp1d,diagpt1 with debug_model"
        quiet = statistics.median(r for r, rec in reads if not rec)
        per_rec = [r - quiet for r, rec in reads if rec]
        pts = mg.points
        probe_reads = count_host_reads(lambda: tdiag.print_points_state(
            mg.grid, mg.state, points=pts))
        debug_reads = count_host_reads(lambda: tdiag.debug_ice(
            mg.grid, mg.state, pts[0]["j"], pts[0]["i"]))
        recs = [r for r in mg.diag_log if "points" in r]
        if not recs or any(x != k12(1) for x in lau_g):
            fail(f"probes: records {len(recs)}, launches {lau_g}")
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out",
                               "phase13_debug_model.txt"), "w") as f:
            f.write(dump)
        out["probes"] = dict(run=ran, reads_per_quiet_step=quiet,
                             reads_per_record=per_rec,
                             probe_reads=probe_reads,
                             debug_reads=debug_reads,
                             points=recs[-1]["points"], launches=lau_g[0])
        print(f"probes ({ran}, 24 steps) on {smi}: host reads per step "
              f"{quiet} without a record, +{per_rec} on the diagnostics "
              f"steps (the record, the probes' {probe_reads} among them); "
              f"the debug dump {debug_reads} per step "
              f"({dump.count('debug_model step')} dumps, "
              f"chiprun_out/phase13_debug_model.txt); last probes "
              f"{json.dumps(recs[-1]['points'])}; launches per step "
              f"{lau_g[0]}")
        out["launches"] = {
            "writer_off": out["writer"][0]["launches"],
            "writer_on": out["writer"][1]["launches"],
            "coupler_per_step": out["coupler"]["launches"],
            "prescribed": out["prescribed"]["launches"],
            "restoring_per_step": out["restoring"]["launches"],
            "pop_nc_step": out["grids"]["launches"],
            "probes_per_step": out["probes"]["launches"]}
        return out
    finally:
        shutil.rmtree(A7_ROOT, ignore_errors=True)


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

    # ---- file forcing, tripole and the baseline runner ------------------
    base = baseline_runs(dev, smi, reset_counters, read_counters)

    # ---- C/CD grids, VP, EAP and the other transports -------------------
    cgrid = c_grid_and_other_dynamics(dev, smi, reset_counters,
                                      read_counters)
    # ---- the column physics of CICE's standard configuration -----------
    cols = column_physics(dev, smi, reset_counters, read_counters)
    # ---- the biogeochemistry --------------------------------------------
    bgc = biogeochemistry(dev, smi, reset_counters, read_counters)
    # ---- coupling and I/O -----------------------------------------------
    a7 = coupling_and_io(dev, smi, reset_counters, read_counters)
    on_a7 = {k: {p: v[k] for p, v in a7["launches"].items()}
             for k in ("evp_fused", "transport_fused", "tracer_fluxes")}
    on_base = {k: {r: base[r]["launches"][k]
                   for r in ("gx1pop", "gx3pop", "tx1pop")}
               for k in ("evp_fused", "transport_fused", "tracer_fluxes")}
    on_cols = {k: {"mushy_dedd_step": cols["mushy_dedd"]["launches"][k],
                   "mushy_dedd_day": cols["day"]["launches"][k],
                   **{o: v["launches"][k] for o, v in cols["sets"].items()}}
               for k in ("evp_fused", "transport_fused", "tracer_fluxes")}
    on_bgc = {k: {"bgcz_auto_3_steps": bgc["launches_auto"][k],
                  "bgcz_k3_step": bgc["launches_k3"][k],
                  "bgcz_day": bgc["bgcz_day"]["launches"][k],
                  "aerosol_24_steps": bgc["aerosol_day"]["launches"][k],
                  **{o: v["launches"][k] for o, v in bgc["sets"].items()}}
              for k in ("evp_fused", "transport_fused", "tracer_fluxes")}

    def on_bgcz(kid, kname):
        k = bgc["kernels"][kid]
        return {"ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound"][0], "bound_by": k["bound"][1],
                "max_abs_err": k["err"], "nt": bgc["nt"],
                "launches": on_bgc[kname],
                **({"chunks": k["chunks"]} if kid == "K2" else {})}

    results = [
        {"name": "evp_fused", "route": "cuda",
         "source": "cice_tpu_torch/csrc/evp_fused.cu",
         "replaces": "cice_tpu/kernels/evp_pallas.py:184",
         "launches": launches["evp_fused"], "max_abs_err": k1_abs,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None,
         "launches_baseline": on_base["evp_fused"],
         "columns": {"ms": cols["k1"]["ms"],
                     "plain_ms": cols["k1"]["plain_ms"],
                     "bound_ms": cols["k1"]["bound"][0],
                     "max_abs_err": cols["k1"]["err"],
                     "launches": on_cols["evp_fused"]},
         "bgcz": on_bgcz("K1", "evp_fused"),
         "coupling_io": {"launches": on_a7["evp_fused"],
                         "perf": [{k: r[k] for k in ("sweep", "grid",
                                                     "route", "s_per_dynstep",
                                                     "Mptsub_s")}
                                  for r in a7["perf"]["rows"]],
                         "stream_768x640_max_abs_err":
                             a7["perf"]["stream_max_abs_err"]}},
        {"name": "transport_fused", "route": "cuda",
         "source": "cice_tpu_torch/csrc/transport_fused.cu",
         "replaces": "cice_tpu/kernels/remap_pallas.py:653",
         "launches": auto_launches["transport_fused"],
         "max_abs_err": k2_abs,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None,
         "launches_baseline": on_base["transport_fused"],
         "cgrid": {"ms": cgrid["k2_cgrid"]["ms"],
                   "plain_ms": cgrid["k2_cgrid"]["plain_ms"],
                   "bound_ms": cgrid["k2_cgrid"]["bound"][0],
                   "max_abs_err": cgrid["k2_cgrid"]["err"],
                   "launches_gridc": cgrid["gridc"]["launches"][
                       "transport_fused"],
                   "launches_dynpicard": cgrid["dynpicard"]["launches"][
                       "transport_fused"]},
         "columns": {"ms": cols["k2"]["ms"],
                     "plain_ms": cols["k2"]["plain_ms"],
                     "bound_ms": cols["k2"]["bound"][0],
                     "max_abs_err": cols["k2"]["err"],
                     "launches": on_cols["transport_fused"]},
         "bgcz": on_bgcz("K2", "transport_fused"),
         "coupling_io": {"launches": on_a7["transport_fused"]}},
        {"name": "tracer_fluxes", "route": "cuda",
         "source": "cice_tpu_torch/csrc/tracer_fluxes.cu",
         "replaces": "cice_tpu/kernels/remap_pallas.py:261",
         "launches": launches["tracer_fluxes"], "max_abs_err": k3_abs,
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": None,
         "ms_dense": k3["dense"]["ms"],
         "bound_ms_dense": k3["dense"]["bound"][0],
         "bound_ms_every_candidate": k3_all_bound,
         "launches_baseline": on_base["tracer_fluxes"],
         "cgrid": {"ms": cgrid["k3_cgrid"]["ms"],
                   "plain_ms": cgrid["k3_cgrid"]["plain_ms"],
                   "bound_ms": cgrid["k3_cgrid"]["bound"][0],
                   "max_abs_err": cgrid["k3_cgrid"]["err"]},
         "bgcz": on_bgcz("K3", "tracer_fluxes"),
         "coupling_io": {"launches": on_a7["tracer_fluxes"]}},
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
                       transport_checks=tc, restart_history=rh,
                       baseline=base, cgrid=cgrid, columns=cols,
                       biogeochemistry=bgc, coupling_io=a7), f,
                  indent=1)
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
