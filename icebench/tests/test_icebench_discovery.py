"""A cell, a configuration, its reference, a traffic mix and a per-layer
metric are each added by new files and BENCHMARK.json entries alone: a
copy of the benchmark with a dummy of each finds them with no other file
edited."""

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


DUMMY_REFERENCE = '''"""A test's reference: the ice reference, each model it builds noted."""

from ..ice.reference import ReferenceModel as _Ice

MADE = []


class ReferenceModel(_Ice):
    def __init__(self, run, device, dtype="float64"):
        MADE.append(dtype)
        super().__init__(run, device, dtype)
'''

RUN = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[2])
import torch
torch.set_num_threads(2)
from icebench import catalog, harness
from icebench.reference.dummy import reference as dummy
out = harness.run_cell(catalog.benchmark(), "dummy.hourly", 7, 0, False,
                       "cpu", shrink=(24, 20), window_steps=1,
                       log=lambda s: None)
ok, checks = harness.verdict("dummy.hourly", out["checks"])
print(json.dumps({"made": dummy.MADE, "ok": ok, "n": out["n"],
                  "checks": checks, "file": dummy.__file__,
                  "nt": out["ctx"].shape["nt"]}))
"""


def test_a_configuration_brings_its_own_reference(tmp_path):
    """A dummy configuration naming a new `reference/dummy/` runs a cell
    through `run_cell` against that reference (initial state, float64
    and float32 check)."""
    root = tmp_path / "checkout"
    shutil.copytree(catalog.HERE, root / "icebench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    ib = root / "icebench"
    bench = catalog.benchmark()
    om025 = bench["workloads"][0]
    bench["configs"].append({"name": "dummy", "source": "a test",
                             "file": "icebench/configs/dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({**om025, "name": "dummy.hourly",
                               "config": "dummy"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = catalog.config(om025["config"])
    (ib / "configs" / "dummy.json").write_text(json.dumps(
        {**cfg, "name": "dummy", "reference": "dummy"}))
    (ib / "workloads" / "dummy.hourly.json").write_text(json.dumps(
        {"limits": catalog.limits(om025["name"])}))
    (ib / "reference" / "dummy").mkdir()
    (ib / "reference" / "dummy" / "__init__.py").write_text("")
    (ib / "reference" / "dummy" / "reference.py").write_text(
        DUMMY_REFERENCE)
    out = subprocess.run([sys.executable, "-c", RUN, str(root),
                          catalog.REPO], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"] == str(ib / "reference" / "dummy" / "reference.py")
    assert got["made"] == [cfg["precision"], "float64", "float32"]
    assert got["n"] == 1 and got["nt"] == 25
    assert got["ok"] is True, got["checks"]


def test_an_input_generator_is_found_by_its_kind():
    from icebench import inputs
    assert inputs.generator("displaced_pole_grid").make
    assert inputs.generator("seeded_caps").make_state
    assert os.path.exists(os.path.join(catalog.HERE, "inputs",
                                       "seeded_caps.py"))
