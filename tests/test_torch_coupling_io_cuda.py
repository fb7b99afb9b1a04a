"""Coupling and I/O of the PyTorch port on the card: the coupler surface,
the background writer, the grid files and the perf sweep's K1 routes.
Every test needs a CUDA device: marked `cuda`, they skip on a machine
without one. On the GPU machine run them with

    python -m pytest --noconftest tests/test_torch_coupling_io_cuda.py -q

- A coupled step on the card (K1 + K3) holds the CPU's to the f32
  tolerance of tests/test_torch_io_cuda.py (2e-3 of each field's largest
  value, with its floors for rounding residue); the exports stay on the
  card.
- With `setup.io_async` the run on the card equals the synchronous one bit
  for bit, and every history and restart file is byte for byte the same.
- pop_nc and MOM grids load onto the card exactly as onto the CPU.
- The perf sweep takes K1's persistent route up to 384x320 and the stream
  route at 768x640, where K1 equals the plain `evp_solve` exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.cli import perf as tperf  # noqa: E402
from cice_tpu_torch.core.grid import GRID_FIELDS  # noqa: E402
from cice_tpu_torch.dynamics.evp import evp_solve  # noqa: E402
from cice_tpu_torch.io import fixtures as tfix  # noqa: E402
from cice_tpu_torch.kernels import evp as kevp  # noqa: E402
from cice_tpu_torch.kernels import remap as kremap  # noqa: E402
from cice_tpu_torch.model.coupling import CoupledIce  # noqa: E402
from cice_tpu_torch.model.driver import Model  # noqa: E402
from cice_tpu_torch.model.state import state_leaves  # noqa: E402
from test_torch_io_cuda import FLOORS, RTOL_F32  # noqa: E402

pytestmark = pytest.mark.cuda

NX, NY, NDTE = 48, 40, 40


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "coupling and I/O are tested against JAX on the CPU)")
    return torch.device("cuda")


def _imports(shp, seed=0):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: lo + (hi - lo) * rng.random(shp)
    tbot = u(245.0, 255.0)
    return {"Sa_u": u(-8.0, 8.0), "Sa_v": u(-8.0, 8.0), "Sa_tbot": tbot,
            "Sa_ptem": tbot + 0.5, "Sa_shum": u(3e-4, 6e-4),
            "Faxa_lwdn": u(170.0, 220.0), "Faxa_snow": u(0.0, 2e-5),
            "So_u": u(-0.1, 0.1), "So_v": u(-0.1, 0.1),
            "So_s": u(32.0, 35.0), "So_t": u(-1.9, -1.5)}


#: exports that carry a history field's rounding residue, and that field
RESIDUE = {"Fioi_meltw": "fresh", "Fioi_salt": "fsalt",
           "Fioi_melth": "fhocn"}


def _close(got, ref, name):
    scale = float(np.abs(ref).max())
    atol = max(RTOL_F32 * scale, FLOORS.get(RESIDUE.get(name, name), 0.0))
    np.testing.assert_allclose(got, ref, rtol=RTOL_F32, atol=atol,
                               err_msg=name)


def test_coupled_step_on_the_card_against_the_cpu(cuda):
    cfg = tconfig.gx1pop_step(NX, NY).with_overrides(**{
        "dynamics.ndte": NDTE})
    ices = {d: CoupledIce(cfg, device=d) for d in (cuda, "cpu")}
    fields = _imports(ices["cpu"].model.grid.shape)
    kevp.launches = kremap.flux_launches = 0
    outs = {}
    for d, ice in ices.items():
        ice.import_fields(fields)
        ice.step()
        out = ice.export_fields()
        assert all(v.device.type == torch.device(d).type
                   for v in out.values())
        outs[d] = convert.exports_to_numpy(out)
    assert kevp.launches == 1 and kremap.flux_launches == 1
    for k, ref in outs["cpu"].items():
        _close(outs[cuda][k], ref, k)
    a = outs[cuda]["Si_ifrac"]
    assert a.min() >= 0.0 and a.max() <= 1.0 + 1e-6
    assert np.all(outs[cuda]["Faii_sen"][a <= 1e-11] == 0.0)


def _io_cfg(root, name, io_async):
    d = os.path.join(str(root), name)
    return tconfig.gx1pop_step(NX, NY).with_overrides(**{
        "dynamics.ndte": NDTE, "setup.io_async": io_async,
        "setup.histfreq": ("1", "x", "x", "x", "x"),
        "setup.histfreq_n": (2, 1, 1, 1, 1), "setup.dumpfreq": "1",
        "setup.history_dir": os.path.join(d, "history"),
        "setup.restart_dir": os.path.join(d, "restart"),
        "setup.pointer_file": os.path.join(d, "restart", "pointer")})


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_background_writer_on_the_card_is_bit_for_bit(cuda, tmp_path):
    runs = {}
    for name, io_async in (("sync", False), ("async", True)):
        m = Model(_io_cfg(tmp_path, name, io_async), device=cuda,
                  enable_history=True)
        m.run(4)                      # run() flushes the writer
        runs[name] = (m, _files(tmp_path / name))
    (a, fa), (b, fb) = runs["sync"], runs["async"]
    assert b.io_writer is not None and b.io_writer.native
    assert sorted(fa) == sorted(fb) and len(fa) == 2 + 4 + 1
    for k in fa:
        if k.endswith("pointer"):
            assert fa[k].replace(b"/sync/", b"/async/") == fb[k]
        else:
            assert fa[k] == fb[k], k
    for x, y in zip(state_leaves(a.state), state_leaves(b.state)):
        assert x.device.type == "cuda" and torch.equal(x, y)


def test_grid_files_load_onto_the_card(cuda, tmp_path):
    b = tfix.ensure_displaced_pole_grid(NX, NY, str(tmp_path))
    forms = tfix.write_grid_forms(b["grid"], b["kmt"], NX, NY,
                                  str(tmp_path / "dp"))
    from cice_tpu_torch.io.grids import load_grid_files
    for fmt, gf, kf in (("pop_nc", forms["pop_nc"], ""),
                        ("mom", forms["mom"], forms["mask"])):
        cfg = tconfig.Config().with_overrides(**{
            "grid.nx_global": NX, "grid.ny_global": NY,
            "grid.grid_format": fmt, "grid.grid_file": gf,
            "grid.kmt_file": kf, "grid.ew_boundary_type": "cyclic"})
        gc, gd = (load_grid_files(cfg, device=d) for d in ("cpu", cuda))
        for k in GRID_FIELDS:
            x, y = getattr(gc, k), getattr(gd, k)
            assert y.device.type == "cuda" and torch.equal(x, y.cpu()), k


def test_perf_sweep_routes_and_stream_k1_exact(cuda):
    sizes = ((192, 160), (384, 320), (768, 640))
    rows = tperf.run_perf(sizes=sizes, ndte=10, out=lambda s: None,
                          device=cuda, n_rep=1)
    assert [r["route"] for r in rows[:3]] == ["persistent", "persistent",
                                              "stream"]
    assert all(r["Mptsub_s"] > 0 for r in rows)
    args, kw = tperf._setup(768, 640, 10, cuda)
    got = kevp.evp_solve_fused(*args, **kw)
    ref = evp_solve(*args, **kw)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert float((g - r).abs().max()) == 0.0, i
    assert float(torch.sqrt(ref[0] ** 2 + ref[1] ** 2).max()) > 0
