"""Named hierarchical wall-clock timers (ice_timers parity; the port's copy
of cice_tpu/utils/timers.py, which it does not import), the program's
profiler ranges and its count of blocking device reads.

Equivalent of cicecore/cicedyn/infrastructure/comm/{mpi,serial}/ice_timers.F90
(`init_ice_timers`:137, `ice_timer_start/stop`:340,433,
`ice_timer_print_all`:691). `Model.step` wraps its host-visible phases
(Total, Forcing, TimeLoop, History) on the host clock, and the in-step
phases are timed by CUDA events through `model_step(timer=)`. The timers
add no device synchronisation: `Model.step` synchronises once after the
step on a CUDA device, where the reference blocks.

Spans. While a profiler runs (`torch.profiler`, or
`torch.autograd.profiler.emit_nvtx` for Nsight Systems) `span(name)` is a
`record_function` range, on the clock of the trace's kernel, copy and
memset events; otherwise it is one shared null context, so a step that is
not profiled builds no range. A `Timers` context opens a range of its own
name. The program's ranges:

  Forcing, TimeLoop, History         the `Timers` contexts of Model.step
  ice:<phase>                        each phase of `model_step` (therm1,
                                     therm2, fsd, bgc, dyn, transport,
                                     ridge, ocean), inside the caller's
                                     timer context
  ice:prep, ice:tendencies,          `model_step` before therm1, between
  ice:fluxes                         the thermo phases and the dynamics,
                                     after ocean
  ice:history_accum,                 Model.step's history accumulation and
  ice:history_write                  files (in a file: ice:history_encode,
                                     ice:history_file)
  ice:diagnostics, ice:restart       Model.step's diagnostics, probes and
                                     restart dumps
  sync:<site>                        each blocking read of the device
                                     (`core.reductions.host_read`,
                                     `host_wait`)

Syncs. Every blocking read a step makes adds one to its site's count in
this process (`sync_counts`): picard, rebin, ridge (the host decisions of
the columns), diag, probe and, on a CUDA device, step_end. The counts are
per process because the column code that reads has no model at hand.

Launches. `print_all` also prints the hand-written kernels' launches by
kernel and route, as `kernels.launch_counts` reads them from the kernel
modules' own counters (host-side, no device read).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

STANDARD_TIMERS = ("Total", "TimeLoop", "History", "Forcing")

_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_syncs: Dict[str, int] = {}


def span(name: str):
    """A profiler range `name` while a profiler runs, else a null
    context."""
    if not _profiling():
        return _NULL
    return torch.profiler.record_function(name)


def count_sync(site: str) -> None:
    """One blocking read of the device at `site`."""
    _syncs[site] = _syncs.get(site, 0) + 1


def sync_counts() -> Dict[str, int]:
    """{site: blocking reads so far} of this process."""
    return dict(_syncs)


@dataclass
class _Entry:
    accum: float = 0.0
    count: int = 0
    started: Optional[float] = None
    vmin: float = float("inf")
    vmax: float = 0.0


@dataclass
class Timers:
    """Registry of named timers with start/stop/ctx and a formatted dump."""

    entries: Dict[str, _Entry] = field(default_factory=dict)

    def init_standard(self):
        for name in STANDARD_TIMERS:
            self.entries.setdefault(name, _Entry())
        return self

    def start(self, name: str):
        e = self.entries.setdefault(name, _Entry())
        e.started = time.perf_counter()

    def stop(self, name: str):
        e = self.entries.get(name)
        if e is None or e.started is None:
            return
        dtv = time.perf_counter() - e.started
        e.accum += dtv
        e.count += 1
        e.vmin = min(e.vmin, dtv)
        e.vmax = max(e.vmax, dtv)
        e.started = None

    class _Ctx:
        def __init__(self, t, name):
            self.t, self.name = t, name

        def __enter__(self):
            self.rf = span(self.name)
            self.rf.__enter__()
            self.t.start(self.name)

        def __exit__(self, *a):
            self.t.stop(self.name)
            self.rf.__exit__(*a)

    def __call__(self, name: str) -> "_Ctx":
        """Context timing `name`, inside a profiler range of that name."""
        return Timers._Ctx(self, name)

    def items(self):
        """(name, accumulated seconds) pairs for non-empty timers."""
        return [(k, e.accum) for k, e in self.entries.items() if e.accum > 0]

    def get(self, name: str) -> float:
        e = self.entries.get(name)
        return e.accum if e else 0.0

    def print_all(self, stats: bool = False) -> str:
        """Formatted dump (ice_timer_print_all:691) with the process's
        blocking reads by site and kernel launches by route; returns the
        text."""
        lines = ["Timing information:", ""]
        for name, e in self.entries.items():
            if e.count == 0 and e.accum == 0.0:
                continue
            line = f"Timer {name:>12}: {e.accum:12.4f} seconds ({e.count} calls)"
            if stats and e.count:
                line += (f"  min {e.vmin:10.6f}  max {e.vmax:10.6f}"
                         f"  mean {e.accum / e.count:10.6f}")
            lines.append(line)
        syncs = sync_counts()
        if syncs:
            lines += ["", "syncs (blocking device reads by site):"]
            lines += [f"Sync  {k:>12}: {n:12d}" for k, n in syncs.items()]
        from ..kernels import launch_counts
        launches = {k: n for k, n in launch_counts().items() if n}
        if launches:
            lines += ["", "launches (hand-written kernels, by route):"]
            lines += [f"Launch {k:>13}: {n:10d}"
                      for k, n in launches.items()]
        text = "\n".join(lines)
        return text
