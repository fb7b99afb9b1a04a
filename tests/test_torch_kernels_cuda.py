"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (cice_tpu_torch.kernels). Every test here needs a CUDA device
and nvcc: marked `cuda`, they skip on a machine without a card. On the GPU
machine run them with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks.)

The kernels keep every multiply and add separately rounded (nvcc
-fmad=false), so they agree with the plain versions to f32 rounding of the
summation order; the bars are the JAX package's engine-vs-engine gates.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch.columns.ridging import ice_strength  # noqa: E402
from cice_tpu_torch.dynamics import remap_exact as rx  # noqa: E402
from cice_tpu_torch.dynamics.common import dyn_prep, evp_params  # noqa: E402
from cice_tpu_torch.dynamics.evp import evp_solve  # noqa: E402
from cice_tpu_torch.kernels import evp as kevp  # noqa: E402
from cice_tpu_torch.kernels import remap as kremap  # noqa: E402
from cice_tpu_torch.model.driver import Model  # noqa: E402
from cice_tpu_torch.model.step import step_dyn_horiz  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "their plain versions are tested against JAX on CPU)")
    return torch.device("cuda")


def _model(cuda, ew="cyclic", ndte=40):
    cfg = tconfig.gx1pop_dyn(48, 40).with_overrides(**{
        "dynamics.ndte": ndte, "grid.ew_boundary_type": ew,
        "setup.conserv_check": True})
    return Model(cfg, device=cuda)


@pytest.mark.parametrize("ew", ["cyclic", "open"])
def test_evp_kernel_matches_plain(cuda, ew):
    m = _model(cuda, ew)
    g, dt = m.grid, m.cfg.setup.dt
    rng = np.random.default_rng(0)
    tm = g.tmask.to(torch.float32)
    aice = torch.as_tensor(0.5 + 0.5 * rng.random(g.shape), dtype=torch.float32,
                           device=cuda) * tm
    vice = 2.0 * aice
    z = torch.zeros(g.shape, device=cuda)
    prep = dyn_prep(g, m.cfg.dynamics, dt, aice=aice, vice=vice, vsno=z,
                    aiceU_prev_mask=torch.zeros(g.shape, dtype=torch.bool,
                                                device=cuda),
                    uvel=z, vvel=z, strairxT=z + 0.1, strairyT=z + 0.05,
                    uocn_T=z + 0.02, vocn_T=z, ss_tltx_T=z, ss_tlty_T=z)
    p = evp_params(m.cfg.dynamics, dt)
    strength = ice_strength(torch.stack([aice / 5] * 5),
                            torch.stack([vice / 5] * 5), aice, vice,
                            m.cfg.dynamics)
    z3 = torch.zeros((4,) + g.shape, device=cuda)
    args = (g, p, prep, strength, z3, z3, z3)
    before = kevp.launches
    got = kevp.evp_solve_fused(*args, uocn=z + 0.02, vocn=z)
    ref = evp_solve(*args, uocn=z + 0.02, vocn=z)
    torch.cuda.synchronize()
    assert kevp.launches == before + 1
    scale = float(torch.sqrt(ref[0] ** 2 + ref[1] ** 2).max())
    err = float(torch.sqrt((got[0] - ref[0]) ** 2 +
                           (got[1] - ref[1]) ** 2).max())
    assert scale > 1e-3 and err / scale < 1e-4


@pytest.mark.parametrize("ew", ["cyclic", "open"])
def test_transport_kernel_matches_plain(cuda, ew):
    m = _model(cuda, ew)
    g, dt = m.grid, m.cfg.setup.dt
    st, _ = step_dyn_horiz(m.static, g, m.state, m.forcing,
                           m.forcing.strax + 0.1, m.forcing.stray + 0.05, dt)
    table = rx.build_flat_table(m.static.registry)
    am, trm = rx.state_to_tracers(st, m.static.registry, table)
    dxs, dys, _ = rx.departure_points_scaled(g, st.uvel, st.vvel, dt, True)
    mom_n, mom_e = (t.contiguous() for t in rx.edge_moments(g, dxs, dys))
    assert float(torch.sqrt(dxs ** 2 + dys ** 2).max()) > 1e-4
    ref_am, ref_trm = kremap.transport_plain(g, mom_n, mom_e, am, trm, table)
    got_am, got_trm = kremap.transport_fused(g, mom_n, mom_e, am, trm, table)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_am, ref_am, rtol=1e-5, atol=1e-7)
    for n in range(len(table)):
        r = ref_trm[:, n]
        scale = float(r.abs().max()) or 1.0
        torch.testing.assert_close(got_trm[:, n], r, rtol=5e-4,
                                   atol=5e-5 * scale)


@pytest.mark.parametrize("ew", ["cyclic", "open"])
def test_tracer_fluxes_kernel_matches_plain(cuda, ew):
    m = _model(cuda, ew)
    g, dt = m.grid, m.cfg.setup.dt
    st, _ = step_dyn_horiz(m.static, g, m.state, m.forcing,
                           m.forcing.strax + 0.1, m.forcing.stray + 0.05, dt)
    table = rx.build_flat_table(m.static.registry)
    am, trm = rx.state_to_tracers(st, m.static.registry, table)
    dxs, dys, _ = rx.departure_points_scaled(g, st.uvel, st.vvel, dt, True)
    mom_n, mom_e = rx.edge_moments(g, dxs, dys)
    mc, mx, my, tc, tx, ty, tstack = rx.construct_fields(g, am, trm, table,
                                                         g.hm)
    args = (g, mom_n, mom_e, mc, mx, my, tc, tx, ty, table)
    before = kremap.flux_launches
    ref = kremap.tracer_fluxes_plain(*args)
    got = kremap.tracer_fluxes_fused(*args, tstack=tstack)
    alone = kremap.tracer_fluxes_fused(*args)      # packs tc|tx|ty itself
    torch.cuda.synchronize()
    assert kremap.flux_launches == before + 2
    for name, a, b, r in zip(("mflxe", "mflxn", "mtflxe", "mtflxn"), got,
                             alone, ref):
        scale = float(r.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(a, r, rtol=2e-5, atol=2e-6 * scale)
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_coupled_step_goes_through_its_kernels(cuda):
    """Model.run on a card: 'fused_pallas' launches K1 + K3, 'auto' K1 + K2,
    and both agree with the plain path."""
    states = {}
    for rk in ("fused_pallas", "auto", "xla"):
        cfg = tconfig.gx1pop_step(48, 40, remap_kernel=rk).with_overrides(**{
            "dynamics.ndte": 40, "setup.conserv_check": True,
            "dynamics.evp_algorithm":
                "standard_2d" if rk == "xla" else "fused_pallas"})
        m = Model(cfg, device=cuda)
        kevp.launches = kremap.launches = kremap.flux_launches = 0
        m.run(2)
        torch.cuda.synchronize()
        counts = (kevp.launches, kremap.launches, kremap.flux_launches)
        assert counts == {"fused_pallas": (2, 0, 2), "auto": (2, 2, 0),
                          "xla": (0, 0, 0)}[rk]
        assert not bool(m.tchecks["oob"])
        assert float(m.tchecks["cons_err_area"]) < 1e-5
        states[rk] = m.state
    for rk in ("fused_pallas", "auto"):
        for k in ("aicen", "vicen", "vsnon", "uvel", "sst"):
            torch.testing.assert_close(getattr(states[rk], k),
                                       getattr(states["xla"], k),
                                       rtol=1e-3, atol=1e-4)


def test_main_path_goes_through_both_kernels(cuda):
    m = _model(cuda)
    kevp.launches = kremap.launches = 0
    m.run_dynamics(2)
    torch.cuda.synchronize()
    assert kevp.launches == 2 and kremap.launches == 2
    assert bool(torch.isfinite(m.state.aicen).all())
    assert not bool(m.tchecks["oob"])
    assert float(m.tchecks["cons_err_area"]) < 1e-5


@pytest.mark.parametrize("nlay", [30, 120])
def test_transport_kernel_large_tables(cuda, nlay):
    """Any NT: wide tracer tables pick smaller tiles (NT=35 keeps 32x4,
    NT=125 drops to 32x1) and must still match the plain version."""
    from cice_tpu_torch.model.state import DEP_AICE, DEP_VICE, TracerSpec
    reg = (TracerSpec("alvl", DEP_AICE, hi=1.0),
           TracerSpec("apnd", DEP_AICE, parent="alvl", hi=1.0),
           TracerSpec("hpnd", DEP_AICE, parent="apnd"),
           TracerSpec("wide", DEP_VICE, nlay, lo=-1.0, hi=1.0))
    table = rx.build_flat_table(reg)
    NT, ncat, ny, nx = len(table), 3, 37, 70
    assert kremap.pick_tile(NT) == ((32, 4) if nlay == 30 else (32, 1))
    gen = torch.Generator(device="cpu").manual_seed(nlay)
    rnd = lambda *s: torch.rand(*s, generator=gen).to(cuda)
    from cice_tpu_torch.core.grid import rectgrid
    g = rectgrid(nx, ny, kmt_type="default", device=cuda)
    aicen = 0.3 * rnd(ncat, ny, nx) * g.hm
    am = torch.cat([1.0 - aicen.sum(0, keepdim=True), aicen]).contiguous()
    trm = (2.0 * rnd(ncat, NT, ny, nx) - 0.5).contiguous()
    u = 0.3 * g.dxU / 3600.0 * (2.0 * rnd(ny, nx) - 1.0)
    v = 0.3 * g.dyU / 3600.0 * (2.0 * rnd(ny, nx) - 1.0)
    dxs, dys, _ = rx.departure_points_scaled(g, u, v, 3600.0, True)
    mom_n, mom_e = (t.contiguous() for t in rx.edge_moments(g, dxs, dys))
    ref_am, ref_trm = kremap.transport_plain(g, mom_n, mom_e, am, trm, table)
    got_am, got_trm = kremap.transport_fused(g, mom_n, mom_e, am, trm, table)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_am, ref_am, rtol=1e-5, atol=1e-7)
    for n in range(NT):
        r = ref_trm[:, n]
        scale = float(r.abs().max()) or 1.0
        torch.testing.assert_close(got_trm[:, n], r, rtol=5e-4,
                                   atol=5e-5 * scale)
