"""Finds what a cell needs by the names in BENCHMARK.json: a configuration
is `configs/<name>.json`, a traffic mix `traffic/<name>.json`, a cell's
correctness limits `workloads/<cell>.json`, a per-layer metric's reader
`metrics/<metric>.py`, and the reference that a configuration names by
its "reference" key `reference/<name>/reference.py`. Adding any of them
is adding a file and an entry.

A reference module defines `ReferenceModel`, the plain path that
`correct` is decided against, with:

    ReferenceModel(run, device, dtype)  run: the configuration's `run`
        overrides as resolved; dtype 'float64' or 'float32'; raises
        ValueError for a configuration it does not carry
    .cfg, .grid, .forcing0              its configuration (the harness
        reads `domain.ncat`, `dynamics.ndte`, `setup.ndtd`), its grid
        (`.shape` is (ny, nx)) and the forcing before the first step
    .zeros()                            a state of zeros of its shapes
    .default_state()                    CICE's default initial state
    .calendar(n)                        the calendar after n steps
    .step(state, cal)                   (state, calendar) one step on
    .tracer_count()                     NT, the tracers transported

A state is a dataclass of tensors and one dict of tracers (`leaves.py`).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json("configs", f"{name}.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def limits(cell: str) -> dict:
    """{number compared: limit} of a cell."""
    return _json("workloads", f"{cell}.json")["limits"]


def metrics_of(bench: dict, cell: str, group: str) -> list:
    """The metrics of `group` ('end_to_end' or 'per_layer') a cell
    reports: those that list it, and those without a list whose `moves`
    (for a per-layer metric) the cell reports."""
    e2e = {m["name"] for m in metrics_of_e2e(bench, cell)}
    out = []
    for m in bench[group]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif group == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def metrics_of_e2e(bench: dict, cell: str) -> list:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def reference(config: dict):
    """The `ReferenceModel` class of the reference that `config` names:
    `reference/<name>/reference.py`, imported as a module of its package
    so that it may import the frozen modules beside it."""
    cname, name = config.get("name"), config.get("reference")
    if name is None:
        raise ValueError(f"configuration {cname!r} names no reference "
                         "(its \"reference\" key)")
    path = os.path.join(HERE, "reference", str(name), "reference.py")
    if not (isinstance(name, str) and _NAME.match(name)
            and os.path.isfile(path)):
        raise ValueError(f"configuration {cname!r} names the reference "
                         f"{name!r}, and there is no "
                         f"{os.path.relpath(path, REPO)}")
    mod = importlib.import_module(f"{__package__}.reference.{name}.reference")
    return mod.ReferenceModel


def reader(metric: str):
    """The module `metrics/<metric>.py` (its `read(ctx)` gives the value
    or None)."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"icebench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
