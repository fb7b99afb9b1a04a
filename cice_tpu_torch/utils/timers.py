"""Named hierarchical wall-clock timers (ice_timers parity; the port's copy
of cice_tpu/utils/timers.py, which it does not import).

Equivalent of cicecore/cicedyn/infrastructure/comm/{mpi,serial}/ice_timers.F90
(`init_ice_timers`:137, `ice_timer_start/stop`:340,433,
`ice_timer_print_all`:691; the standard timer set ids at :42-89). The
reference wraps every model phase; `Model.step` wraps its host-visible
phases (Total, Forcing, TimeLoop, History) on the host clock, and the
in-step phases are timed by CUDA events through `model_step(timer=)`.
The timers add no device synchronisation: `Model.step` synchronises once
after the step on a CUDA device, where the reference blocks.

Timer names follow the reference so perf_suite-style comparisons carry
over: Total, TimeLoop, Dynamics, Advection, Column, Thermo, Shortwave,
Ridging, FloeSize, Coupling, ReadWrite, Diags, History, Bound, BGC,
Forcing, UpdState.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

STANDARD_TIMERS = (
    "Total", "TimeLoop", "Dynamics", "Advection", "Column", "Thermo",
    "Shortwave", "Ridging", "FloeSize", "Coupling", "ReadWrite", "Diags",
    "History", "Bound", "BGC", "Forcing", "UpdState",
)


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
            self.t.start(self.name)

        def __exit__(self, *a):
            self.t.stop(self.name)

    def __call__(self, name: str) -> "_Ctx":
        return Timers._Ctx(self, name)

    def items(self):
        """(name, accumulated seconds) pairs for non-empty timers."""
        return [(k, e.accum) for k, e in self.entries.items() if e.accum > 0]

    def get(self, name: str) -> float:
        e = self.entries.get(name)
        return e.accum if e else 0.0

    def print_all(self, stats: bool = False) -> str:
        """Formatted dump (ice_timer_print_all:691); returns the text."""
        lines = ["Timing information:", ""]
        for name, e in self.entries.items():
            if e.count == 0 and e.accum == 0.0:
                continue
            line = f"Timer {name:>12}: {e.accum:12.4f} seconds ({e.count} calls)"
            if stats and e.count:
                line += (f"  min {e.vmin:10.6f}  max {e.vmax:10.6f}"
                         f"  mean {e.accum / e.count:10.6f}")
            lines.append(line)
        text = "\n".join(lines)
        return text
