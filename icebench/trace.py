"""What the benchmark reads from a torch.profiler trace of some steps: the
device's busy time (the union of the intervals in which a kernel, copy or
memset ran), the traced window (from the first traced step's start to the
last one's end, on the host's ranges "step"), the kernel launches, the
device time of each kernel name, and the idle gaps, each labelled by the
innermost host range open when it began ("phase:<name>" inside
`model_step`, "step" elsewhere in `Model.step`)."""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceSummary:
    steps: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    launches: int = 0
    kernel_s: dict = field(default_factory=dict)     # name -> seconds
    spans: dict = field(default_factory=dict)        # host range -> count
    gaps: list = field(default_factory=list)         # (seconds, label)

    def seconds_of(self, *parts) -> float:
        """Device seconds of the kernels whose name holds any of `parts`."""
        return sum(s for k, s in self.kernel_s.items()
                   if any(p in k for p in parts))

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        gaps = defaultdict(float)
        for s, label in self.gaps:
            gaps[label] += s
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:200], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in top]}


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(path: str) -> TraceSummary:
    """Reduce the Chrome trace at `path` (times in microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat == "user_annotation":
            host.append(e)
    steps = [e for e in host if e["name"] == "step"]
    out = TraceSummary()
    if not steps:
        return out
    w0 = min(e["ts"] for e in steps)
    w1 = max(e["ts"] + e["dur"] for e in steps)
    out.steps = len(steps)
    out.window_s = (w1 - w0) * 1e-6
    ks = defaultdict(float)
    iv = []
    for e in dev:
        a, b = e["ts"], e["ts"] + e["dur"]
        if b <= w0 or a >= w1:
            continue
        iv.append((max(a, w0), min(b, w1)))
        if e["cat"] == "kernel":
            ks[e["name"]] += e["dur"] * 1e-6
            out.launches += 1
    out.kernel_s = dict(ks)
    busy = _merge(iv)
    out.busy_s = sum(b - a for a, b in busy) * 1e-6
    spans = defaultdict(int)
    for e in host:
        if w0 <= e["ts"] < w1:
            spans[e["name"]] += 1
    out.spans = dict(spans)
    # idle gaps inside the window, labelled by the innermost host range
    # open at the gap's start
    host = sorted(host, key=lambda e: e["ts"])
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        label, best = "outside a step", None
        for e in host:
            if e["ts"] > a:
                break
            if e["ts"] + e["dur"] >= a and (best is None or
                                            e["dur"] < best["dur"]):
                best = e
        if best is not None:
            label = best["name"]
        out.gaps.append(((b - a) * 1e-6, label))
    return out
