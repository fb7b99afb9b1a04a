"""A cell, a configuration, a traffic mix and a per-layer metric are each
added by new files and BENCHMARK.json entries alone: a copy of the
benchmark with a dummy of each finds them with no other file edited."""

import json
import os
import shutil
import subprocess
import sys

from icebench import catalog

PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from icebench import catalog
b = catalog.benchmark()
print(json.dumps({
    "cell": catalog.workload(b, "dummy.hourly"),
    "config": catalog.config("dummy")["run"],
    "traffic": catalog.traffic("dummy_mix")["warm_steps"],
    "limits": catalog.limits("dummy.hourly"),
    "per_layer": [m["name"] for m in
                  catalog.metrics_of(b, "dummy.hourly", "per_layer")],
    "reads": catalog.reader("dummy_ms").read(None),
    "here": catalog.HERE}))
"""


def test_dummy_cell_config_and_metric_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(catalog.HERE, root / "icebench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = catalog.benchmark()
    bench["configs"].append({"name": "dummy", "source": "a test",
                             "file": "icebench/configs/dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy.hourly", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_ms", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "driver", "moves": "step_ms",
                               "workloads": ["dummy.hourly"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    ib = root / "icebench"
    (ib / "configs" / "dummy.json").write_text(json.dumps(
        {"run": {"grid.nx_global": 8}}))
    (ib / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"warm_steps": 7}))
    (ib / "workloads" / "dummy.hourly.json").write_text(json.dumps(
        {"limits": {"start_gap": 1.0, "window_gap": 2.0}}))
    (ib / "metrics" / "dummy_ms.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    out = subprocess.run([sys.executable, "-c", PROBE, str(root)],
                         capture_output=True, text=True, check=True)
    got = json.loads(out.stdout)
    assert got["here"] == str(ib)
    assert got["cell"]["traffic"] == "dummy_mix"
    assert got["config"] == {"grid.nx_global": 8}
    assert got["traffic"] == 7
    assert got["limits"] == {"start_gap": 1.0, "window_gap": 2.0}
    assert "dummy_ms" in got["per_layer"]
    assert got["reads"] == 42.0
    # the other cells do not report it
    assert "dummy_ms" not in [m["name"] for m in catalog.metrics_of(
        bench, bench["workloads"][0]["name"], "per_layer")]


def test_an_input_generator_is_found_by_its_kind():
    from icebench import inputs
    assert inputs.generator("displaced_pole_grid").make
    assert inputs.generator("seeded_caps").make_state
    assert os.path.exists(os.path.join(catalog.HERE, "inputs",
                                       "seeded_caps.py"))
