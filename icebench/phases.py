"""The benchmark's timer of the step's phases, handed to the program as
`Model.step(timer=...)`. Each phase is timed on the device by a pair of
CUDA events (on the CPU by the host clock) and opens a profiler range
"phase:<name>", so a trace shows which phase the host was in."""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class PhaseTimer:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.step = 0
        self._open: list = []            # (step, name, start, end)

    def __call__(self, name: str):
        return _Phase(self, name)

    def per_step_ms(self, steps) -> dict:
        """{phase: ms per step} summed over the steps in `steps`."""
        steps = set(steps)
        if self.cuda:
            torch.cuda.synchronize()
        tot = defaultdict(float)
        for s, name, a, b in self._open:
            if s in steps:
                tot[name] += a.elapsed_time(b) if self.cuda else \
                    (b - a) * 1e3
        return {k: v / max(len(steps), 1) for k, v in tot.items()}


class _Phase:
    def __init__(self, timer: PhaseTimer, name: str):
        self.t, self.name = timer, name

    def __enter__(self):
        self.rf = torch.profiler.record_function("phase:" + self.name)
        self.rf.__enter__()
        if self.t.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.a.record()
        else:
            self.a = time.perf_counter()

    def __exit__(self, *exc):
        if self.t.cuda:
            b = torch.cuda.Event(enable_timing=True)
            b.record()
        else:
            b = time.perf_counter()
        self.t._open.append((self.t.step, self.name, self.a, b))
        self.rf.__exit__(*exc)
