"""The seeded inputs: one seed always gives the same bytes and another
seed another state, with the same ice cells and concentrations."""

import hashlib
import os

import torch

from icebench import catalog, inputs
from icebench.inputs import seeded_caps
from icebench.leaves import leaves

GRID = {"grid": {"kind": "displaced_pole_grid", "nx": 24, "ny": 20}}
PARAMS = {"kind": "seeded_caps", "thick": 0.3, "snow": 0.5}


def _digest(paths):
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def test_grid_files_repeat_their_bytes(tmp_path):
    g = inputs.make_all(GRID, 1, str(tmp_path / "cache"),
                        str(tmp_path / "a"))["grid"]
    first = _digest([g["grid"], g["kmt"]])
    os.remove(g["grid"])
    inputs.make_all(GRID, 2, str(tmp_path / "cache"), str(tmp_path / "b"))
    assert _digest([g["grid"], g["kmt"]]) == first


def _states(tmp_path, *seeds):
    made = inputs.make_all(GRID, 0, str(tmp_path / "cache"), str(tmp_path))
    run = inputs.resolve({
        "grid.nx_global": 24, "grid.ny_global": 20,
        "grid.grid_format": "pop_bin", "grid.grid_type": "displaced_pole",
        "grid.grid_file": "{grid.grid}", "grid.kmt_file": "{grid.kmt}",
        "grid.ew_boundary_type": "cyclic", "setup.ice_ic": "none"}, made)
    ref = catalog.reference(catalog.config("om025"))(run, "cpu", "float32")
    return [leaves(seeded_caps.make_state(ref, PARAMS, s)) for s in seeds]


def test_initial_state_repeats_for_a_seed(tmp_path):
    a, b, c = _states(tmp_path, 2 ** 33 + 1, 2 ** 33 + 1, 2 ** 33 + 2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["vicen"], c["vicen"])
    assert not torch.equal(a["vsnon"], c["vsnon"])
    assert float(a["aicen"].sum()) > 0


def test_every_seed_steps_the_same_ice_cells(tmp_path):
    a, c = _states(tmp_path, 5, 2 ** 31 + 5)
    for k in a:
        if k not in ("vicen", "vsnon"):
            assert torch.equal(a[k], c[k]), k
    assert torch.equal(a["vicen"] > 0, c["vicen"] > 0)
    assert float(a["aicen"].sum(0).max()) <= 1.0
