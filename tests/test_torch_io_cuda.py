"""Restart and history of the PyTorch port on the card (cice_tpu_torch.io
through Model.step with the CUDA kernels K1 and K3). Every test needs a
CUDA device: marked `cuda`, they skip on a machine without one. On the GPU
machine run them with

    python -m pytest --noconftest tests/test_torch_io_cuda.py -q

- A run restarted from its step-2 dump equals the uninterrupted 4-step run
  bit for bit (`torch.equal` on every leaf), once with
  `torch.use_deterministic_algorithms(True)`, which raises at any operation
  PyTorch knows to be nondeterministic.
- The history file the card writes holds what the CPU writes for the same
  run, to the f32 tolerance of tests/test_torch_step.py: 2e-3 of each
  field's largest value, with absolute floors for fields that hold
  rounding residue (FLOORS).
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch.kernels import evp as kevp  # noqa: E402
from cice_tpu_torch.kernels import remap as kremap  # noqa: E402
from cice_tpu_torch.model.driver import Model  # noqa: E402
from cice_tpu_torch.model.state import state_leaves  # noqa: E402

pytestmark = pytest.mark.cuda

NX, NY, NDTE = 48, 40, 40
RTOL_F32 = 2e-3

# Absolute floors (f32) for fields that hold rounding residue, from
# tests/test_torch_step.py's FLOORS in each field's history units: melt of
# ~1e-9 m in midwinter (the residue of the converged surface balance) and
# what the ponds make of it through a sqrt (~1e-4); thickness, area and
# age differences per dt carry a few ulp of the differenced quantity
# (history scales the rates by 8.64e6); ridged area 1 - alvl where nothing
# ridged is rounding residue, which sirdgthick divides by puny = 1e-11.
_MELT, _POND, _RATE = 1e-6, 1e-3, 1e-9 * 8.64e6
FLOORS = {
    "melts": _MELT, "meltt": _MELT, "dpnd_initial": _MELT,
    "dpnd_initialn": _MELT, "fpond": _MELT, "siflfwdrain": _MELT,
    "meltsliq": _MELT, "melttn_ai": _MELT, "dpnd_ridge": 1e-9,
    # the CMIP rates of the melts: rho * melt / dt
    "sisndmassmelt": _MELT * 330.0 / 3600.0,
    "sidmassmelttop": _MELT * 917.0 / 3600.0,
    "dpnd_melt": 1e-9,
    "apond": _POND, "apond_ai": _POND, "apondn": _POND, "simpconc": _POND,
    "apeff": _POND, "apeff_ai": _POND, "apeffn": _POND, "simpeffconc": _POND,
    "albpnd": _POND, "hpond": _POND, "hpond_ai": _POND, "hpondn": _POND,
    "simpthick": _POND,
    "fresh": 1e-6, "fresh_ai": 1e-6, "siflfwbot": 1e-6, "fsalt": 1e-8,
    "fsalt_ai": 1e-8, "siflsaltbot": 1e-8, "fhocn": 0.3, "fhocn_ai": 0.3,
    "daidtt": _RATE, "dvidtt": _RATE, "dsnow": _RATE, "daidtd": _RATE,
    "dvidtd": _RATE, "dagedtt": 1e-3, "dagedtd": 1e-3,
    "ardg": 1e-6, "ardgn": 1e-6, "sirdgconc": 1e-6, "vrdg": 1e-5,
    "vrdgn": 1e-5, "sirdgthick": 1e-5 / 1e-11,
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "restart and history are tested against JAX on CPU)")
    return torch.device("cuda")


def _cfg(root, name, **over):
    d = os.path.join(str(root), name)
    return tconfig.gx1pop_step(NX, NY).with_overrides(**{
        "dynamics.ndte": NDTE,
        "setup.histfreq": ("1", "x", "x", "x", "x"),
        "setup.histfreq_n": (2, 1, 1, 1, 1),
        "setup.history_dir": os.path.join(d, "history"),
        "setup.dumpfreq": "1", "setup.dumpfreq_n": 2,
        "setup.restart_dir": os.path.join(d, "restart"),
        "setup.pointer_file": os.path.join(d, "restart", "pointer"),
        **over})


def _read_nc(path):
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        return (dict(f._attributes), dict(f.dimensions),
                {k: (v.dimensions, dict(v._attributes), np.array(v[:]))
                 for k, v in f.variables.items()})


@pytest.mark.parametrize("fmt", ["npz", "cdf1"])
@pytest.mark.parametrize("deterministic", [False, True],
                         ids=["default", "deterministic"])
def test_restart_bit_for_bit_on_the_card(cuda, tmp_path, fmt,
                                         deterministic):
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        a = Model(_cfg(tmp_path, "A", **{"setup.restart_format": fmt}),
                  device=cuda)
        kevp.launches = kremap.flux_launches = 0
        a.run(2)
        ptr = shutil.copy(a.cfg.setup.pointer_file, tmp_path / "ptr2")
        a.run(2)
        assert kevp.launches == 4 and kremap.flux_launches == 4
        b = Model(_cfg(tmp_path, "B", **{
            "setup.restart_format": fmt, "setup.runtype": "continue",
            "setup.pointer_file": str(ptr)}), device=cuda)
        assert b.istep == 2
        b.run(2)
    finally:
        torch.use_deterministic_algorithms(prev)
    for i, (x, y) in enumerate(zip(state_leaves(b.state),
                                   state_leaves(a.state))):
        assert x.device.type == "cuda" and x.dtype == y.dtype
        assert torch.equal(x, y), f"leaf_{i}"
    assert b.calendar == a.calendar


def test_history_file_from_the_card_equals_the_cpu(cuda, tmp_path):
    """2 steps with one stream averaged over both, on the card and on the
    CPU: the same cdf1 file to the f32 tolerance."""
    files = {}
    for dev in ("cpu", cuda):
        cfg = _cfg(tmp_path, str(dev), **{"setup.hist_cmip": True})
        m = Model(cfg, device=dev, enable_history=True)
        m.run(2)
        name = "iceh.1." + m.calendar.timestamp() + ".nc"
        files[str(dev)] = _read_nc(os.path.join(cfg.setup.history_dir, name))
    (cg, cd, cv), (gg, gd, gv) = files["cpu"], files[str(cuda)]
    assert gg == cg and gd == cd and list(gv) == list(cv)
    bad = []                  # every field out of tolerance, not the first
    for k, (dims, attrs, ref) in cv.items():
        got = gv[k][2]
        assert gv[k][0] == dims and gv[k][1] == attrs, k
        assert got.dtype == ref.dtype and got.shape == ref.shape, k
        ref64, got64 = ref.astype(np.float64), got.astype(np.float64)
        live = ref64 < 1e29                         # spval outside ocean
        np.testing.assert_array_equal(got64 < 1e29, live, err_msg=k)
        scale = float(np.abs(ref64[live]).max()) if live.any() else 0.0
        atol = max(RTOL_F32 * scale, FLOORS.get(k, 0.0))
        diff = np.abs(got64[live] - ref64[live])
        if (diff > atol + RTOL_F32 * np.abs(ref64[live])).any():
            bad.append((k, scale, float(diff.max())))
    assert not bad, bad
    assert float(np.abs(cv["congel"][2]).max()) > 0.0
