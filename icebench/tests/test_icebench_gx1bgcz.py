"""The z-tracer configuration gx1bgcz and its cell gx1bgcz.hourly: its
reference keeps `catalog.py`'s contract and refuses what it does not
carry, its NCAR monthly writer repeats by seed and takes the grid's shape,
a run of the cell at 24x20 on the CPU reads correct, and its per-layer
readers read what a traced run gives."""

import hashlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

from icebench import catalog, harness
from icebench import inputs as inp
from icebench.inputs import ncar_monthly, seeded_caps
from icebench.leaves import leaves
from icebench.trace import TraceSummary

SIZE = (24, 20)
CELL = "gx1bgcz.hourly"
METRICS = ("zbgc_ms", "bgcz_transport_ms", "bgcz_k2_roofline")


def _made(tmp_path, seed, size=SIZE, name="run"):
    config = harness._shrunk(catalog.config("gx1bgcz"), size)
    made = inp.make_all(config["inputs"], seed, str(tmp_path / "cache"),
                        str(tmp_path / name))
    return config, made


def _run(config, made):
    return inp.resolve({**config["run"], **catalog.traffic("hourly")["run"]},
                       made)


def _digest(d):
    h = hashlib.sha256()
    for f in ("ncar_bulk_2005.npz", "ocean_clim.npz"):
        with open(os.path.join(d, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def test_the_reference_keeps_the_contract(tmp_path):
    config, made = _made(tmp_path, 3)
    ref = catalog.reference(config)(_run(config, made), "cpu", "float32")
    assert ref.tracer_count() == 266
    assert ref.grid.shape == (SIZE[1], SIZE[0])
    assert ref.cfg.dynamics.ndte == 120 and ref.cfg.setup.ndtd == 1
    st = leaves(ref.default_state())
    assert set(st) == set(leaves(ref.zeros()))
    ice = st["aicen"] > 0
    assert bool((st["trcrn.fbri"][ice] == 1.0).all())
    assert bool((st["trcrn.bgc_Nit_mf"][:, 0][ice] == 1.0).all())
    assert float(st["trcrn.bgc_Nit"].max()) == ref.cfg.zbgc.nit_data
    s1, cal = ref.step(seeded_caps.make_state(ref, config["initial_state"],
                                              3), ref.calendar(0))
    assert cal.istep == 1
    assert all(bool(v.isfinite().all()) for v in leaves(s1).values()
               if v.is_floating_point())


@pytest.mark.parametrize("override", [
    {"tracers.tr_brine": False}, {"zbgc.z_tracers": False},
    {"forcing.atm_data_type": "box2001"}, {"thermo.ktherm": 2},
    {"zbgc.tr_zaero": True}, {"forcing.atm_data_dir": ""}],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_the_reference_refuses_what_it_does_not_carry(tmp_path, override):
    config, made = _made(tmp_path, 3)
    with pytest.raises(ValueError):
        catalog.reference(config)({**_run(config, made), **override}, "cpu",
                                  "float32")


def test_the_ice_reference_refuses_the_configuration(tmp_path):
    config, made = _made(tmp_path, 3)
    with pytest.raises(ValueError, match="tr_brine|atm_data_type"):
        catalog.reference({"reference": "ice"})(_run(config, made), "cpu",
                                                "float32")


def test_the_writer_repeats_by_seed_and_takes_the_grid_shape(tmp_path):
    _, a = _made(tmp_path, 2 ** 33 + 5, name="a")
    _, b = _made(tmp_path, 2 ** 33 + 5, name="b")
    _, c = _made(tmp_path, 2 ** 33 + 6, name="c")
    assert _digest(a["forcing"]["atm_dir"]) == _digest(b["forcing"]["atm_dir"])
    assert _digest(a["forcing"]["atm_dir"]) != _digest(c["forcing"]["atm_dir"])
    with np.load(os.path.join(a["forcing"]["atm_dir"],
                              "ncar_bulk_2005.npz")) as z:
        assert set(z.files) == set(ncar_monthly.ATM_FIELDS)
        assert all(z[k].shape == (12, SIZE[1], SIZE[0]) for k in z.files)
        # January is the southern summer: the air over the Southern
        # Ocean's ice is warmer than in July
        lat, _ = ncar_monthly.grid_latlon(a["grid"]["grid"])
        south = lat < -60.0
        assert z["Tair"][0][south].mean() > z["Tair"][6][south].mean() + 5
    with np.load(os.path.join(a["forcing"]["ocn_dir"],
                              "ocean_clim.npz")) as z:
        assert set(z.files) == set(ncar_monthly.OCN_FIELDS)
        assert all(z[k].shape == (12, SIZE[1], SIZE[0]) for k in z.files)
    _, d = _made(tmp_path, 2 ** 33 + 5, size=(16, 12), name="d")
    with np.load(os.path.join(d["forcing"]["atm_dir"],
                              "ncar_bulk_2005.npz")) as z:
        assert z["Tair"].shape == (12, 12, 16)


def test_the_writer_refuses_a_grid_it_cannot_read(tmp_path):
    p = tmp_path / "grid.bin"
    p.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="displaced_pole_grid"):
        ncar_monthly.grid_latlon(str(p))


@pytest.fixture(scope="module")
def traced(bench):
    out = harness.run_cell(bench, CELL, 2 ** 32 + 77, 0, True, "cpu",
                           shrink=SIZE, window_steps=2, log=lambda s: None)
    return out


def test_a_traced_run_of_the_cell_reads_correct(bench, traced):
    line = harness.result_line(bench, CELL, traced, True,
                               {"platform": "cpu", "kind": "cpu",
                                "count": 1, "memory_peak_bytes": 0})
    assert line["correct"] is True, line["checks"]
    assert traced["ctx"].shape["nt"] == 266
    got = line["metrics"]
    assert got["zbgc_ms"]["value"] > 0
    assert got["bgcz_transport_ms"]["value"] > 0
    assert "bgcz_k2_roofline" not in got     # no kernel runs on the CPU
    # the z tracers run inside therm1, which times them too
    assert traced["ctx"].phases["therm1"] > traced["ctx"].phases["zbgc"]


def test_the_readers_read_nothing_without_a_trace():
    ctx = SimpleNamespace(phases=None, trace=None, shape=dict(
        ny=384, nx=320, ncat=5, nt=266))
    for m in METRICS:
        assert catalog.reader(m).read(ctx) is None, m


def test_the_roofline_reads_the_kernel_of_a_trace():
    """K2's bound at NT 266 over its traced ms a pass: 3.5 ms a pass (the
    port's measured K2 time at this shape) reads 0.41 / 3.5."""
    tr = TraceSummary(spans={"phase:transport": 6},
                      kernel_s={"transport_kernel<float>": 6 * 3.5e-3})
    ctx = SimpleNamespace(phases={"zbgc": 9.0, "transport": 20.0},
                          trace=tr, shape=dict(ny=384, nx=320, ncat=5,
                                               nt=266))
    got = {m: catalog.reader(m).read(ctx) for m in METRICS}
    assert got["zbgc_ms"] == 9.0 and got["bgcz_transport_ms"] == 20.0
    assert got["bgcz_k2_roofline"] == pytest.approx(100 * 0.4102 / 3.5,
                                                    rel=1e-3)
