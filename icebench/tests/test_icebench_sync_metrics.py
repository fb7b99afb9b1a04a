"""The readers of the program's blocking reads, `host_syncs_per_step` and
`sync_idle_ms`, on small Chrome traces of the form torch.profiler exports
and `trace.summarize` reads (times in microseconds)."""

import json
from types import SimpleNamespace

import pytest

from icebench import catalog
from icebench.trace import summarize


def _host(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur}


#: two steps of 1000 us; the device idles 100-200 after a rebin read,
#: 400-600 in a dyn phase and 1100-1300 after a Picard read; the step's
#: closing wait opens no gap (the device is busy to the window's end)
SYNCED = [_host("step", 0, 1000), _host("step", 1000, 1000),
          _kernel(0, 100), _host("sync:rebin", 90, 60), _kernel(200, 200),
          _host("ice:dyn", 380, 220), _kernel(600, 400),
          _kernel(1000, 100), _host("sync:picard", 1090, 110),
          _kernel(1300, 700), _host("sync:step_end", 1950, 50)]

#: the same without the program's ranges (a checkout that opens none)
UNSYNCED = [e for e in SYNCED if not e["name"].startswith("sync:")]


def _read(tmp_path, events, metric):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return catalog.reader(metric).read(SimpleNamespace(
        trace=summarize(str(path))))


def test_syncs_and_their_idle_per_step(tmp_path):
    assert _read(tmp_path, SYNCED, "host_syncs_per_step") == 1.5
    assert _read(tmp_path, SYNCED, "sync_idle_ms") == \
        pytest.approx((100 + 200) * 1e-3 / 2)


@pytest.mark.parametrize("metric", ["host_syncs_per_step", "sync_idle_ms"])
def test_nothing_to_read_gives_none(tmp_path, metric):
    assert _read(tmp_path, UNSYNCED, metric) is None
    assert catalog.reader(metric).read(SimpleNamespace(trace=None)) is None
