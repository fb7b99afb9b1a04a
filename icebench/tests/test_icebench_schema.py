"""BENCHMARK.json against the rules of its schema: names and
units of the allowed characters, the keys each entry has, every metric
with its reader, every cell with its configuration, traffic and limits."""

import json
import os
import re

import pytest

from icebench import catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def _names(bench):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            yield e["name"]
    for w in bench["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in bench["configs"]:
        yield from c["reduced"]


def test_names_and_units_use_allowed_characters(bench):
    for n in _names(bench):
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for e in bench["configs"] + bench["workloads"]:
        assert TEXT.match(e["why"]), e["name"]
    for c in bench["configs"]:
        assert TEXT.match(c["source"])
        assert len(c["reduced"]) <= 16
    for m in bench["per_layer"]:
        assert TEXT.match(m["layer"])


def test_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["icebench"]
    assert len(json.dumps(bench)) < 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"icebench/configs/{c['name']}.json"
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(bench, group):
    for m in bench[group]:
        assert callable(catalog.reader(m["name"]).read), m["name"]


def test_every_cell_has_its_files(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        cfg = catalog.config(w["config"])
        assert {"run", "inputs", "initial_state", "precision"} <= set(cfg)
        t = catalog.traffic(w["traffic"])
        assert t["warm_steps"] >= 1
        lim = catalog.limits(w["name"])
        assert set(lim) == {"start_gap", "window_gap"}
        e2e = catalog.metrics_of(bench, w["name"], "end_to_end")
        pl = catalog.metrics_of(bench, w["name"], "per_layer")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert pl


def test_command_stays_inside_paths(bench):
    cmd = bench["command"]
    assert cmd[0] == "python3" and cmd[1].startswith("icebench/")
    assert os.path.exists(os.path.join(catalog.REPO, cmd[1]))
