"""One run of one cell: set-up, the measured window, the check step, the
reference, the metrics and the result line.

    python3 icebench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

Set-up makes the cell's inputs from the seed (the grid is cached in
`icebench/.cache/`; what an input makes for one run alone goes to a
directory of the run's own under $TMPDIR), builds the initial state with
the code of the reference that the configuration names
(`catalog.reference`), builds the program's `Model` with history on, hands
it that state and drives it through the traffic's warm steps, the first of
which loads the kernels (built into the checkout on its first run). The
window then steps `Model.step` until `--seconds` have passed; with
`--trace 1` the phases are timed by CUDA events and a block of steps is
traced by torch.profiler. After the window the peak memory is read, one
more step (the check step) is taken from the window's last state, the
program is freed and the reference follows the warm steps and the check
step (`check.py`). Every metric is read by its own reader,
`metrics/<name>.py`.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

from . import catalog, check
from . import inputs as inp
from .leaves import leaves, to_host
from .phases import PhaseTimer
from .trace import summarize
from . import yardstick

#: top-level modules that no run may load (compared whole: the program's
#: name begins with the last one's)
FORBIDDEN = ("jax", "jaxlib", "flax", "cice_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["CICE_TPU_TORCH_BUILD"] = os.path.join(
        catalog.REPO, "cice_tpu_torch", "_build")
    cache = os.path.join(catalog.HERE, ".cache")
    os.environ["CICE_TPU_TORCH_FIXTURES"] = os.path.join(cache, "fixtures")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "extensions")
    return cache


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _shrunk(config: dict, shrink) -> dict:
    """The configuration at another grid size (the CPU tests' sizes)."""
    if shrink is None:
        return config
    nx, ny = shrink
    c = json.loads(json.dumps(config))
    c["inputs"]["grid"].update(nx=nx, ny=ny)
    c["run"].update({"grid.nx_global": nx, "grid.ny_global": ny})
    return c


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, *, system=None, shrink=None,
             window_steps=None, log=print) -> dict:
    """Run a cell and return {"ctx": what the metrics' readers read,
    "checks": {number: (value, worst leaf)}, "n": window steps}.

    `system` builds the thing under test (default: the program);
    `shrink` (nx, ny) and `window_steps` (a fixed count in place of
    `seconds`) serve the tests and the calibration."""
    device = torch.device(device)
    cell = catalog.workload(bench, cell_name)
    config = _shrunk(catalog.config(cell["config"]), shrink)
    traffic = catalog.traffic(cell["traffic"])
    if system is None:
        from .system import Program as system
    cache = cache_dirs()
    run_dir = tempfile.mkdtemp(prefix="icebench-")
    t_in = time.perf_counter()
    try:
        made = inp.make_all(config["inputs"], seed, cache, run_dir)
        run = inp.resolve({**config["run"], **traffic["run"]}, made)
        run.update({"setup.history_dir": os.path.join(run_dir, "history/"),
                    "setup.restart_dir": os.path.join(run_dir, "restart/"),
                    "setup.pointer_file": os.path.join(
                        run_dir, "restart", "ice.restart_file")})
        # the initial state, made by the reference's code from the seed
        reference = catalog.reference(config)
        ref = reference(run, device, config["precision"])
        gen = inp.generator(config["initial_state"]["kind"])
        s0 = leaves(gen.make_state(ref, config["initial_state"], seed))
        initial = to_host(s0)
        nt = ref.tracer_count()
        ncat, (ny, nx) = ref.cfg.domain.ncat, ref.grid.shape
        ndte, ndtd = ref.cfg.dynamics.ndte, ref.cfg.setup.ndtd
        state_bytes = yardstick.state_bytes(s0)
        del ref
        t_model = time.perf_counter()
        sut = system(run, device, traffic.get("history", False), s0)
        del s0
        timer = PhaseTimer(device) if trace else None
        t_warm = time.perf_counter()
        warm_s = []
        for i in range(traffic["warm_steps"]):
            if timer is not None:
                timer.step = -1 - i
            a = time.perf_counter()
            sut.step(timer=timer)
            _sync(device)
            warm_s.append(time.perf_counter() - a)
        start = to_host(sut.leaves())
        _sync(device)
        setup_s = process_age()
        log(f"set-up {setup_s:.2f} s: inputs and initial state "
            f"{t_model - t_in:.2f} s, model {t_warm - t_model:.2f} s, "
            f"warm steps {', '.join(f'{s:.3f}' for s in warm_s)} s")

        # -- the window ------------------------------------------------------
        lo = 2 if trace else -1
        hi = lo + traffic["trace_steps"] if trace else -1
        prof = None
        times, host = [], [sut.host_seconds()]
        _sync(device)
        t0 = time.perf_counter()
        n = 0
        while True:
            if n == lo:
                prof = _profiler(device)
                prof.start()
            if timer is not None:
                timer.step = n
            a = time.perf_counter()
            with torch.profiler.record_function("step"):
                sut.step(timer=timer)
            times.append(time.perf_counter() - a)
            host.append(sut.host_seconds())
            n += 1
            if n == hi:
                _sync(device)
                prof.stop()
            done = (n >= window_steps if window_steps is not None
                    else time.perf_counter() - t0 >= seconds)
            if done and n >= hi:
                break
        _sync(device)
        window_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)

        # -- the check step, then the reference -------------------------------
        pre = to_host(sut.leaves())
        sut.step()
        _sync(device)
        post = to_host(sut.leaves())
        sut.close()
        del sut
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        checks = check.gaps(reference, run, device, initial,
                            traffic["warm_steps"], start, pre,
                            traffic["warm_steps"] + n, post, log=log)
        log(f"window {n} steps in {window_s:.3f} s; reference "
            f"{time.perf_counter() - t_ref:.2f} s")
        log("step ms: " + " ".join(f"{t * 1e3:.1f}" for t in times))

        quiet = [i for i in range(n) if not lo <= i < hi]
        ctx = SimpleNamespace()
        ctx.cell, ctx.config, ctx.traffic = cell, config, traffic
        ctx.setup_s, ctx.peak_bytes = setup_s, peak
        ctx.window_s, ctx.steps, ctx.step_s = window_s, n, times
        ctx.quiet = quiet
        ctx.phases = timer.per_step_ms(quiet) if timer else None
        ctx.host_ms = {k: sum(host[i + 1][k] - host[i][k] for i in quiet)
                       / len(quiet) * 1e3 for k in host[0]}
        ctx.trace = None
        if prof is not None:
            path = os.path.join(run_dir, "trace.json")
            prof.export_chrome_trace(path)
            ctx.trace = summarize(path)
        ctx.shape = dict(ny=ny, nx=nx, ncat=ncat, nt=nt, ndte=ndte,
                         ndtd=ndtd, state_bytes=state_bytes)
        ctx.least_step_ms = yardstick.step_least_ms(
            ny, nx, ndte, ndtd, nt, ncat, state_bytes)
        return {"ctx": ctx, "checks": checks, "n": n}
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def read_metrics(bench: dict, ctx, trace: bool) -> dict:
    """{name: {"value", "unit"}} of the cell's end-to-end metrics (trace
    0) or per-layer ones (trace 1); a reader that finds nothing is left
    out."""
    group = "per_layer" if trace else "end_to_end"
    out = {}
    for m in catalog.metrics_of(bench, ctx.cell["name"], group):
        v = catalog.reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def verdict(cell: str, checks: dict) -> tuple:
    """(correct, {name: {"value", "limit", "leaf"}}) against the cell's
    limits; a missing or non-finite number is not correct."""
    lim = catalog.limits(cell)
    ok, out = True, {}
    for name, limit in lim.items():
        v, leaf = checks.get(name, (math.inf, None))
        good = math.isfinite(v) and v <= limit
        ok = ok and good
        out[name] = {"value": v if math.isfinite(v) else None,
                     "limit": limit, "leaf": leaf}
    return ok, out


def result_line(bench: dict, cell: str, out: dict, trace: bool,
                device: dict) -> dict:
    """The last line's object of a run's output `out` (`run_cell`):
    correct, attempted, failed, metrics, device, with `trace` the
    device's busy and window seconds and the breakdown, and last the
    numbers compared beside their limits."""
    ctx = out["ctx"]
    correct, checks = verdict(cell, out["checks"])
    result = {"correct": correct, "attempted": out["n"], "failed": 0,
              "metrics": read_metrics(bench, ctx, trace),
              "device": dict(device)}
    if trace and ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one icebench cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = catalog.benchmark()
    cell = catalog.workload(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"icebench: {args.workload} needs {cell['chips']} CUDA "
              "device(s)", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(dev)
    log = lambda s: print(f"icebench: {s}", file=sys.stderr, flush=True)
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), dev, log=log)
    ctx = out["ctx"]
    bad = forbidden_modules()
    if bad:
        print(f"icebench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 5
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell["chips"], "memory_peak_bytes": ctx.peak_bytes}
    result = result_line(bench, args.workload, out, bool(args.trace),
                         device)
    checks = result["checks"]
    for name, c in checks.items():
        print(f"icebench: check {name} {c['value']} limit {c['limit']} "
              f"(worst leaf {c['leaf']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
