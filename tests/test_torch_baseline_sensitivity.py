"""How far the JAX package moves under a 1e-15 change of its own input,
against how far the port is from it (slow tier: ~10 minutes on the CPU).
These are the measurements behind two tolerances of the port's tests and
the tx1pop entry of ROADMAP section C:

  * tx1pop differs from baselines/r05/tx1pop.json in hmax (up to 41 %),
    ke and umax. At 180x120 in f64, a 1e-15 relative change of the JAX
    package's vicen grows to ~1e-2 of the largest velocity and ~1e-1 of
    the largest stress within 4-5 steps, first in the fold's rows; the
    port's distance from the JAX package follows that envelope step by
    step and leaf by leaf.
  * under file forcing the level ponds at the ice edge (pond area
    fractions of 1e-9..1e-5) move by ~1e-7 in apnd and ~1e-3 in hpnd under
    the same perturbation (tests/test_torch_forcing_step.py compares pond
    volume there).
  * tx1pop at 48x32 matches the JAX package at 1e-8 for 8 steps in every
    field but the ponds' rounding residue.

    JAX_PLATFORMS=cpu python -m pytest -m slow -s \
        tests/test_torch_baseline_sensitivity.py
"""

import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from cice_tpu.cli import main as jcli  # noqa: E402
from cice_tpu.model.driver import Model as JModel  # noqa: E402
from cice_tpu_torch.cli import main as tcli  # noqa: E402
from cice_tpu_torch.io import fixtures as tfix  # noqa: E402
from cice_tpu_torch.model.driver import Model as TModel  # noqa: E402

pytestmark = pytest.mark.slow
PERTURB = 1.0 + 1e-15
ENVELOPE_STEPS = 12
ENVELOPE_RATIO = 50.0


def _jax_runs(cfg, steps, record):
    """(unperturbed, perturbed) JAX runs of `steps` steps; `record(m)` is
    read from each after the last step."""
    out = []
    for scale in (1.0, PERTURB):
        m = JModel(cfg)
        m.state = m.state.replace(vicen=m.state.vicen * scale)
        for _ in range(steps):
            m.step()
        out.append(record(m))
    return out


def test_tx1pop_dynamics_stay_in_the_reference_envelope(tmp_path,
                                                       monkeypatch):
    """tx1pop in f64 at 180x120 (fixtures of that size in both packages;
    the full 360x240 runs on the card, `python -m
    cice_tpu_torch.sensitivity`): after every step, uvel, vvel, the three
    stresses and vicen of the port against the JAX package, leaf by leaf,
    beside the envelope of the JAX package with vicen x (1 + 1e-15) --
    over the whole grid, the fold's two rows and the rows more than 8 from
    the fold. The port may exceed one perturbation's envelope by a little
    (its own rounding touches every operation), never by ENVELOPE_RATIO."""
    from cice_tpu.io import fixtures as jfix
    jax.config.update("jax_enable_x64", True)
    dims = {"gx3": (24, 20), "gx1": (32, 24), "tx1": (180, 120)}
    monkeypatch.setattr(jfix, "GRID_DIMS", dims)
    monkeypatch.setattr(tfix, "GRID_DIMS", dims)
    monkeypatch.setenv("CICE_TPU_TORCH_FIXTURES", str(tmp_path / "t"))
    monkeypatch.setenv("CICE_TPU_FIXTURES", str(tmp_path / "j"))
    ns = lambda: argparse.Namespace(opts="tx1pop", set=[
        "dtype=float64", "grid.nx_global=180", "grid.ny_global=120",
        'setup.dumpfreq="x"', f"setup.restart_dir={tmp_path}/r/",
        f"setup.pointer_file={tmp_path}/r/ptr"])
    jm, jp = JModel(jcli.build_config(ns())), JModel(jcli.build_config(ns()))
    jp.state = jp.state.replace(vicen=jp.state.vicen * PERTURB)
    tm = TModel(tcli.build_config(ns()), device="cpu")
    parts = {"all": np.s_[..., :, :], "fold": np.s_[..., -2:, :],
             "south": np.s_[..., :-8, :]}
    worst = 0.0
    for step in range(1, ENVELOPE_STEPS + 1):
        jm.step()
        jp.step()
        tm.step()
        line = []
        for k in ("uvel", "vvel", "stressp", "stressm", "stress12",
                  "vicen"):
            ref = np.asarray(getattr(jm.state, k))
            env = np.abs(np.asarray(getattr(jp.state, k)) - ref)
            dev = np.abs(getattr(tm.state, k).numpy() - ref)
            scale = float(np.abs(ref).max())
            for part, sl in parts.items():
                d, e = float(dev[sl].max()), float(env[sl].max())
                ratio = d / max(e, 1e-15 * scale)
                worst = max(worst, ratio)
                line.append(f"{k} {part} {d / scale:.1e}/{e / scale:.1e}")
                assert ratio <= ENVELOPE_RATIO, (step, k, part, d, e)
        print(f"step {step} (port/envelope, relative): " + ", ".join(line))
    print(f"largest port/envelope ratio {worst:.1f}; hmax JAX "
          f"{jm.diag_log[-1]['hmax']!r}, perturbed "
          f"{jp.diag_log[-1]['hmax']!r}, port {tm.diag_log[-1]['hmax']!r}")


def test_edge_ponds_move_in_the_reference(tmp_path):
    """The ncar + clim configuration of tests/test_torch_forcing_step.py
    in f64: two steps of the JAX package, unperturbed and perturbed."""
    from test_torch_forcing_step import NX, NY, _cfgs
    jax.config.update("jax_enable_x64", True)
    d = str(tmp_path)
    arrs = tfix.make_displaced_pole_arrays(NX, NY)
    lat, lon = np.rad2deg(arrs["TLAT"]), np.rad2deg(arrs["TLON"])
    tfix.write_ncar_npz(d, lat, lon)
    tfix.write_ocean_clim_npz(d, lat, lon)
    _, jcfg = _cfgs("float64", **{
        "forcing.atm_data_type": "ncar", "forcing.atm_data_dir": d,
        "forcing.ocn_data_type": "clim", "forcing.ocn_data_dir": d})
    (a0, h0), (a1, h1) = _jax_runs(
        jcfg, 2, lambda m: (np.asarray(m.state.trcrn["apnd"]),
                            np.asarray(m.state.trcrn["hpnd"])))
    da, dh = float(np.abs(a1 - a0).max()), float(np.abs(h1 - h0).max())
    print(f"\nedge ponds under vicen x (1 + 1e-15): apnd moves {da!r} "
          f"(max {float(a0.max())!r}), hpnd {dh!r}")
    assert da > 1e-9 and dh > 1e-6


# the ponds' rounding residue (see test_edge_ponds_move_in_the_reference)
# and the fluxes that carry it
POND_RESIDUE = ("apnd", "hpnd", "fresh", "fpond", "dpnd_initial",
                "dpnd_initialn", "dpnd_ridge")


def test_small_tx1pop_matches_the_reference_but_for_residue_ponds(
        tmp_path, monkeypatch):
    """tx1pop at 48x32 in f64 (fixtures of that size in both packages):
    8 steps match the JAX package at 1e-8 of each field's largest value in
    every field but the ponds' rounding residue (1e-18 m of snow melt on
    cold ice, through a square root), with tests/test_torch_step.py's
    FLOORS."""
    from cice_tpu.io import fixtures as jfix
    from cice_tpu_torch import convert
    from test_torch_step import CHECK_BOUNDS, FLOORS, RTOL
    jax.config.update("jax_enable_x64", True)
    dims = {"gx3": (24, 20), "gx1": (32, 24), "tx1": (48, 32)}
    monkeypatch.setattr(jfix, "GRID_DIMS", dims)
    monkeypatch.setattr(tfix, "GRID_DIMS", dims)
    monkeypatch.setenv("CICE_TPU_TORCH_FIXTURES", str(tmp_path / "t"))
    monkeypatch.setenv("CICE_TPU_FIXTURES", str(tmp_path / "j"))
    ns = lambda: argparse.Namespace(opts="tx1pop", set=[
        "dtype=float64", "grid.nx_global=48", "grid.ny_global=32"])
    jm = JModel(jcli.build_config(ns()))
    tm = TModel(tcli.build_config(ns()), device="cpu")
    for step in range(8):
        jm.step()
        tm.step()
        for got, ref in ((convert.state_to_numpy(tm.state), jm.state),
                         (convert.fluxout_to_numpy(tm.flux), jm.flux)):
            g, r = convert.tree_to_numpy(got), convert.tree_to_numpy(ref)
            for k, b in r.items():
                leaf = k.split(".")[-1]
                a, b = np.asarray(g[k]), np.asarray(b)
                if leaf in POND_RESIDUE or leaf in CHECK_BOUNDS:
                    continue
                if b.dtype == np.bool_:
                    np.testing.assert_array_equal(a, b, err_msg=k)
                    continue
                tol = max(RTOL["float64"] * float(np.abs(b).max()),
                          FLOORS.get(leaf, (0.0, 0.0))[0])
                np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                           err_msg=f"step {step + 1} {k}")
    assert float(np.abs(np.asarray(jm.state.uvel)).max()) > 1e-2
