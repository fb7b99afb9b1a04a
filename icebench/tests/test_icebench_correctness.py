"""The comparison that decides `correct` fails what it must: the control
(the reference in the program's place with its state in bfloat16) and each
fault a one-chip cell can have, planted under the timed path, at a grid a
test run can hold; and a sound run of the program passes. Each case drives
the rest of a run as the benchmark does (inputs, set-up, window, check
step, reference, verdict, result line)."""

import json

import pytest

from icebench import catalog, harness
from icebench.control import control
from faults import KINDS, Faulty
from icebench.system import Program

SIZE = (24, 20)


def _run(cell, system=None):
    bench = catalog.benchmark()
    out = harness.run_cell(bench, cell, 2 ** 31 + 99, 0, False, "cpu",
                           system=system, shrink=SIZE, window_steps=2,
                           log=lambda s: None)
    line = harness.result_line(bench, cell, out, False,
                               {"platform": "cpu", "kind": "cpu",
                                "count": 1, "memory_peak_bytes": 0})
    return out, line


def test_sound_run_is_correct_and_its_last_line_is_complete():
    out, line = _run("om025.hourly")
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    assert line["attempted"] == 2 and line["failed"] == 0
    assert set(line["metrics"]) == {"step_ms", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    json.loads(json.dumps(line))


def test_control_is_not_correct():
    _, line = _run("om025.hourly", control(catalog.config("om025")))
    assert line["correct"] is False
    assert all(c["value"] is None or c["value"] > c["limit"]
               for c in line["checks"].values())


@pytest.mark.parametrize("kind", KINDS)
def test_fault_is_not_correct(kind):
    _, line = _run("om025.hourly", lambda *a: Faulty(Program(*a), kind))
    assert line["correct"] is False


def test_traced_run_reads_its_per_layer_metrics():
    bench = catalog.benchmark()
    out = harness.run_cell(bench, "om025.hourly", 4, 0, True, "cpu",
                           shrink=SIZE, window_steps=1, log=lambda s: None)
    got = harness.read_metrics(bench, out["ctx"], True)
    for m in ("column_ms", "dyn_ms", "transport_ms", "ridge_ms",
              "step_p90_ms", "forcing_ms", "history_ms", "step_mfu"):
        assert got[m]["value"] > 0, m
    assert "k1_roofline" not in got      # no kernel runs on the CPU
