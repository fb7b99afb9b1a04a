"""The point probes of the PyTorch port (cice_tpu_torch/model/diagnostics.py
`probe_points`, `print_points_state`, `debug_ice`, and the `print_points`
and `debug_model` hooks of Model.step) against the JAX package's dicts on
the same state (the port's after one step, carried over as numpy). No JAX
step compiles. The probes gather their values on the device and read them
in one host read per call, where the JAX package reads every value
separately.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from cice_tpu.model import diagnostics as jdiag  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.config import Config  # noqa: E402
from cice_tpu_torch.measure import count_host_reads  # noqa: E402
from cice_tpu_torch.model import diagnostics as tdiag  # noqa: E402
from cice_tpu_torch.model.driver import Model  # noqa: E402
from test_torch_restart import _jax_state  # noqa: E402

OVER = {"grid.nx_global": 24, "grid.ny_global": 20,
        "grid.grid_format": "latlon", "dynamics.ndte": 20,
        "setup.diagfreq": 1}
PROBES = ((90.0, -65.0, 75.0), (0.0, -45.0, 200.0))


def _close(got, ref, dtype):
    """Dict against dict: ints and strings equal, floats to the dtype's
    rounding (f32: the probe's sums may add in another order)."""
    assert sorted(got) == sorted(ref)
    rtol = 1e-15 if dtype == "float64" else 1e-6
    for k in ref:
        if isinstance(ref[k], (int, str)):
            assert got[k] == ref[k], k
        else:
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(ref[k], np.float64),
                                       rtol=rtol, atol=1e-30, err_msg=k)


@pytest.fixture(scope="module", params=["float64", "float32"])
def stepped(request):
    cfg = Config().with_overrides(**OVER, dtype=request.param)
    m = Model(cfg, device="cpu")
    m.step()
    jgrid = jmake_grid(JConfig().with_overrides(**OVER,
                                                dtype=request.param))
    return request.param, m, jgrid, _jax_state(
        convert.state_to_numpy(m.state))


def test_print_points_state_matches_jax(stepped):
    dtype, m, jgrid, jst = stepped
    lat, lon = PROBES[0], PROBES[1]
    got = tdiag.print_points_state(m.grid, m.state, lat, lon)
    ref = jdiag.print_points_state(jgrid, jst, lat, lon)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        _close(g, r, dtype)
    assert any(p["aice"] > 0.1 and p["uvel"] != 0.0 for p in got)
    pts = tdiag.probe_points(m.grid, lat, lon)
    assert tdiag.print_points_state(m.grid, m.state, points=pts) == got


def test_debug_ice_matches_jax(stepped):
    dtype, m, jgrid, jst = stepped
    for p in tdiag.probe_points(m.grid, *PROBES[:2]):
        got = tdiag.debug_ice(m.grid, m.state, p["j"], p["i"], "post_step")
        ref = jdiag.debug_ice(jgrid, jst, p["j"], p["i"], "post_step")
        _close(got, ref, dtype)


def test_one_host_read_per_probe_call(stepped):
    _, m, _, _ = stepped
    pts = tdiag.probe_points(m.grid)
    assert count_host_reads(lambda: tdiag.print_points_state(
        m.grid, m.state, points=pts)) == 1
    assert count_host_reads(lambda: tdiag.debug_ice(
        m.grid, m.state, pts[0]["j"], pts[0]["i"])) == 1


def test_model_hooks(capsys):
    """print_points adds the probes to each diagnostics record (one host
    read more than the record without them); debug_model prints the
    column at debug_model_i/j (or the first probe) from debug_model_step
    on."""
    base = Config().with_overrides(**OVER, dtype="float64")
    m0 = Model(base, device="cpu")
    m1 = Model(base.with_overrides(**{"setup.print_points": True}),
               device="cpu")
    m0.step()
    m1.step()
    assert count_host_reads(m1.step) == count_host_reads(m0.step) + 1
    rec = m1.diag_log[-1]
    assert rec["points"] == tdiag.print_points_state(m1.grid, m1.state)
    capsys.readouterr()
    m2 = Model(base.with_overrides(**{
        "setup.debug_model": True, "setup.debug_model_step": 2,
        "setup.debug_model_i": 3, "setup.debug_model_j": 17}), device="cpu")
    m2.step()
    assert capsys.readouterr().out == ""
    m2.step()
    out = capsys.readouterr().out
    assert out.startswith("debug_model step 2:") and "'j': 17, 'i': 3" in out
