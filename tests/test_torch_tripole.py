"""PyTorch port vs JAX package on tripole grids: the analytic grid formats
(latlon, tripole, tripoleT, displaced_pole) and pop_bin tripole grids, the
inter-grid averages across the fold, the direct-shift branch of the remap
fluxes, and three coupled steps of the tests/test_tripole_model.py
configuration (32x24, default ocean, ndte=10) with a 5 m/s northward wind
in place of its calm one: under calm air the ice stays at rest, and the
wind makes dynamics and transport cross the seam.

Tolerances: grid metrics are host float64 NumPy in both packages (1e-12 of
each array's largest value); averages and fluxes in f64 at 1e-12; the
coupled steps use tests/test_torch_step.py's f64 bar (1e-8 of each field's
largest value) and its FLOORS.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax.numpy as jnp  # noqa: E402

from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu.core import grid as jgrid  # noqa: E402
from cice_tpu.dynamics import remap_exact as jrx  # noqa: E402
from cice_tpu.model.driver import Model as JModel  # noqa: E402
from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.core import grid as tgrid  # noqa: E402
from cice_tpu_torch.dynamics import remap_exact as trx  # noqa: E402
from cice_tpu_torch.io import fixtures as tfix  # noqa: E402
from cice_tpu_torch.model import driver as tdriver  # noqa: E402
from test_torch_step import RTOL, _compare  # noqa: E402

TRIPOLE = {"grid.grid_format": "tripole", "grid.nx_global": 32,
           "grid.ny_global": 24, "grid.kmt_type": "none",
           "forcing.atm_data_type": "calm", "forcing.ocn_data_type": "none",
           "dynamics.ndte": 10, "thermo.nit": 4, "dtype": "float64"}


# Absolute floors beyond test_torch_step's, for rounding residue: dvidtd,
# dvsdtd and dagedtd are (x_after - x_before) / dt over transport. Where
# the JAX package leaves an ulp of a ~1 m thickness (4e-16 m / 3600 s =
# 1.2e-19 m/s) or of an ice age of a few hours (9e-13 s / 3600 s = 2.5e-16),
# the port leaves 0.
EXTRA_FLOORS = {"dvidtd": 1e-18, "dvsdtd": 1e-18, "dagedtd": 1e-14}


def _compare_f64(got, ref, what):
    g, r = convert.tree_to_numpy(got), convert.tree_to_numpy(ref)
    for k in [k for k in r if k.split(".")[-1] in EXTRA_FLOORS]:
        a, b = np.asarray(g.pop(k)), np.asarray(r.pop(k))
        atol = max(RTOL["float64"] * float(np.abs(b).max()),
                   EXTRA_FLOORS[k.split(".")[-1]])
        np.testing.assert_allclose(a, b, rtol=RTOL["float64"], atol=atol,
                                   err_msg=f"{what}: {k}")
    _compare(g, r, what, "float64")


def _pair(**over):
    return (tconfig.Config().with_overrides(**over),
            JConfig().with_overrides(**over))


def _grids_equal(tg, jg):
    assert tg.shape == jg.shape and tg.bc == type(tg.bc)(jg.bc.ew, jg.bc.ns)
    for k in tgrid.GRID_FIELDS:
        ref = np.asarray(getattr(jg, k))
        np.testing.assert_allclose(getattr(tg, k).numpy(), ref, rtol=0,
                                   atol=1e-12 * max(1.0, float(
                                       np.abs(ref).max())), err_msg=k)


@pytest.mark.parametrize("over", [
    {"grid.grid_format": "latlon"},
    {"grid.grid_format": "tripole", "grid.kmt_type": "none"},
    {"grid.grid_format": "tripole", "grid.kmt_type": "default",
     "grid.ns_boundary_type": "tripoleT"},
    {"grid.grid_format": "displaced_pole"}],
    ids=["latlon", "tripole", "tripoleT", "displaced_pole"])
def test_analytic_grids_equal_jax(over):
    t, j = _pair(**{"grid.nx_global": 24, "grid.ny_global": 20,
                    "dtype": "float64", **over})
    _grids_equal(tgrid.make_grid(t, "cpu"), jgrid.make_grid(j))


def test_tripole_needs_even_nx():
    t, _ = _pair(**{"grid.grid_format": "tripole", "grid.nx_global": 25})
    with pytest.raises(ValueError, match="even nx_global"):
        tgrid.make_grid(t, "cpu")


def test_pop_bin_tripole_grid_equals_jax(tmp_path):
    """A tx1-format tripole POP binary at 16x12 read with
    ns_boundary_type='tripole', as the tx1pop option set reads tx1."""
    arrs = tfix.make_tripole_arrays(16, 12)
    gpath, kpath = str(tmp_path / "g.bin"), str(tmp_path / "k.bin")
    tfix.write_pop_grid_binary(gpath, arrs)
    tfix.write_kmt_binary(kpath, arrs["kmt"])
    t, j = _pair(**{"grid.nx_global": 16, "grid.ny_global": 12,
                    "grid.grid_format": "pop_bin",
                    "grid.grid_type": "tripole", "grid.grid_file": gpath,
                    "grid.kmt_file": kpath,
                    "grid.ns_boundary_type": "tripole", "dtype": "float64"})
    tg, jg = tgrid.make_grid(t, "cpu"), jgrid.make_grid(j)
    assert tg.bc.tripole
    _grids_equal(tg, jg)


def test_grid_averages_across_the_fold():
    t, j = _pair(**{"grid.grid_format": "tripole", "grid.nx_global": 24,
                    "grid.ny_global": 20, "grid.kmt_type": "default",
                    "dtype": "float64"})
    tg, jg = tgrid.make_grid(t, "cpu"), jgrid.make_grid(j)
    f = np.random.default_rng(4).standard_normal(tg.shape)
    for (src, dst) in jgrid._DIRS:
        for kind in ("S", "A", "F"):
            ref = np.asarray(jgrid.grid_average_X2Y(kind, jnp.asarray(f),
                                                    src, dst, jg))
            got = tgrid.grid_average_X2Y(kind, torch.as_tensor(f), src, dst,
                                         tg).numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-12,
                                       atol=1e-12 * np.abs(ref).max(),
                                       err_msg=f"{kind} {src}->{dst}")


def test_remap_fluxes_direct_shift_branch_f64():
    """At a fold the donors are shifted directly (their gradients as
    vectors): every flux of a tripole grid against the JAX package."""
    t, j = _pair(**{"grid.grid_format": "tripole", "grid.nx_global": 16,
                    "grid.ny_global": 16, "grid.kmt_type": "none",
                    "dtype": "float64"})
    tg, jg = tgrid.make_grid(t, "cpu"), jgrid.make_grid(j)
    from cice_tpu.model import state as js
    from cice_tpu_torch.model import state as ts
    # a 6-tracer table with every chain type (alvl -> apnd -> hpnd,
    # hs -> qsno), as tests/test_torch_remap.py uses
    jt, tt = ((jrx if m is js else trx).build_flat_table((
        m.TracerSpec("alvl", m.DEP_AICE, hi=1.0),
        m.TracerSpec("apnd", m.DEP_AICE, parent="alvl", hi=1.0),
        m.TracerSpec("hpnd", m.DEP_AICE, parent="apnd"),
        m.TracerSpec("qsno", m.DEP_VSNO, 1, lo=-5e8, hi=0.0)))
        for m in (js, ts))
    ncat, NT, (ny, nx) = 2, len(jt), tg.shape
    rng = np.random.default_rng(9)
    r = lambda *s: rng.random(s)
    f = dict(mc=r(ncat + 1, ny, nx), mx=0.1 * (r(ncat + 1, ny, nx) - 0.5),
             my=0.1 * (r(ncat + 1, ny, nx) - 0.5),
             tc=1.0 + r(ncat, NT, ny, nx),
             tx=0.2 * (r(ncat, NT, ny, nx) - 0.5),
             ty=0.2 * (r(ncat, NT, ny, nx) - 0.5))
    dx = float(np.asarray(jg.dxU).min())
    u = 0.3 * dx / 3600.0 * (2.0 * r(ny, nx) - 1.0)
    v = 0.3 * dx / 3600.0 * (2.0 * r(ny, nx) - 1.0) + 0.2 * dx / 3600.0
    dxs, dys, _ = jrx.departure_points_scaled(jg, jnp.asarray(u),
                                              jnp.asarray(v), 3600.0, True)
    tdxs, tdys, _ = trx.departure_points_scaled(tg, torch.as_tensor(u),
                                                torch.as_tensor(v), 3600.0,
                                                True)
    np.testing.assert_allclose(tdxs.numpy(), np.asarray(dxs), rtol=1e-13)
    order = ("mc", "mx", "my", "tc", "tx", "ty")
    ref = jrx.remap_fluxes(jg, dxs, dys, *(jnp.asarray(f[k]) for k in order),
                           jt)
    got = trx.remap_fluxes(tg, tdxs, tdys,
                           *(torch.as_tensor(f[k]) for k in order), tt)
    for name, a, b in zip(("mflxe", "mflxn", "mtflxe", "mtflxn"), got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max(),
                                   err_msg=name)
    # east edges of the top row draw on donors in the fold's ghost row
    assert float(np.abs(np.asarray(ref[0])[:, -1]).max()) > 0.0


def test_three_coupled_steps_match_jax_across_the_seam():
    tcfg, jcfg = _pair(**{**TRIPOLE,
                          "forcing.atm_data_type": "uniform_north"})
    jm, tm = JModel(jcfg), tdriver.Model(tcfg, device="cpu")
    assert tm.grid.bc.ns == "tripole" and tm.grid.bc.ew == "cyclic"
    for step in range(3):
        jm.step()
        tm.step()
        _compare_f64(convert.state_to_numpy(tm.state), jm.state,
                     f"step {step + 1} state")
        _compare_f64(convert.fluxout_to_numpy(tm.flux), jm.flux,
                     f"step {step + 1} flux")
    # the ice moves next to the fold
    assert float(np.abs(np.asarray(jm.state.vvel)[-2]).max()) > 1e-3


def test_fold_symmetric_state_stays_fold_symmetric():
    """A state mirrored about the fold (i <-> nx-1-i) stays mirrored
    through 3 coupled steps of the calm configuration."""
    tcfg, _ = _pair(**TRIPOLE)
    m = tdriver.Model(tcfg, device="cpu")
    ny, nx = m.grid.shape
    rng = np.random.default_rng(13)
    w = rng.random((ny, nx))
    w = 0.5 * (w + w[:, ::-1])
    s = m.state
    m.state = s.replace(aicen=s.aicen * torch.as_tensor(w),
                        vicen=s.vicen * torch.as_tensor(w))
    m.run(3)
    for k in ("aicen", "vicen", "vsnon"):
        a = getattr(m.state, k)
        torch.testing.assert_close(a, a.flip(-1), rtol=1e-12, atol=1e-15,
                                   msg=k)
    for k, a in m.state.trcrn.items():
        torch.testing.assert_close(a, a.flip(-1), rtol=1e-12, atol=1e-12,
                                   msg=k)
    assert float((m.state.aicen - s.aicen).abs().max()) > 0.0


def test_pure_transport_conserves_across_the_seam():
    """horizontal_remap_exact with a northward flow through the fold
    conserves area and volume (the seam is interior, not an outflow)."""
    tcfg, _ = _pair(**{**TRIPOLE, "grid.kmt_type": "none"})
    m = tdriver.Model(tcfg, device="cpu")
    ny, nx = m.grid.shape
    jj = torch.arange(ny, dtype=torch.float64)[:, None].expand(ny, nx)
    v = torch.where(jj >= ny - 8, 0.2, 0.0) * m.grid.uvm
    st = dataclasses.replace(m.state, vvel=v)
    w = m.grid.tarea * m.grid.hm
    vol0 = float((st.vice * w).sum())
    for _ in range(3):
        st, diag = trx.horizontal_remap_exact(
            m.grid, st, m.static.registry, m.forcing.Tf, 1800.0,
            l_dp_midpt=True, conserv_check=True)
    assert float(diag["cons_err_area"]) < 1e-12
    assert abs(float((st.vice * w).sum()) - vol0) <= 1e-12 * vol0
    assert bool(torch.isfinite(st.vicen).all())
