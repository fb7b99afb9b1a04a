"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (cice_tpu_torch.kernels). Every test here needs a CUDA device
and nvcc: marked `cuda`, they skip on a machine without a card. On the GPU
machine run them with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks.)

K4, therm1's BL99 temperature solve, equals `temperature_changes_plain`
bit for bit in every output and in the pass count (`-k k4`): on the
gx1pop state with both conductivities, at om025's size, on edge columns,
in float64, on every (nslyr, nilyr) the library is built for, at an exit
after one pass and at `nit`, on the per-pass route alone and on a 1x2
mesh of two ranks sharing the card.

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
    before = kevp.launches, kevp.persistent_launches
    got = kevp.evp_solve_fused(*args, uocn=z + 0.02, vocn=z)
    ref = evp_solve(*args, uocn=z + 0.02, vocn=z)
    torch.cuda.synchronize()
    assert (kevp.launches, kevp.persistent_launches) == \
        (before[0] + 1, before[1] + 1)      # 40x48 fits the card
    scale = float(torch.sqrt(ref[0] ** 2 + ref[1] ** 2).max())
    err = float(torch.sqrt((got[0] - ref[0]) ** 2 +
                           (got[1] - ref[1]) ** 2).max())
    assert scale > 1e-3 and err / scale < 1e-4


def _evp_problem(cuda, ny, nx, ew, ndte, seed=0):
    """EVP inputs with moving ice, nonzero incoming stresses, an ice-free
    band, seabed stress and an ocean current, made with numpy from a seed."""
    from cice_tpu_torch.core.grid import rectgrid
    from cice_tpu_torch.core.halo import BC
    cfg = tconfig.Config().with_overrides(**{
        "grid.nx_global": nx, "grid.ny_global": ny,
        "grid.ew_boundary_type": ew, "dynamics.ndte": ndte,
        "dynamics.coriolis": "latitude", "dynamics.seabed_stress": True,
        "dynamics.threshold_hw": 5e3})
    g = rectgrid(nx, ny, kmt_type="default", bc=BC(ew, "open"), device=cuda)
    rng = np.random.default_rng(seed)
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    jj, ii = np.mgrid[0:ny, 0:nx]
    tm = g.hm.cpu().numpy()
    aice = (0.9 - 0.3 * np.exp(-((ii - nx / 2) / 6.0) ** 2)) * tm
    aice[: ny // 5] = 0.0
    vice = aice * (1.0 + 0.4 * rng.random((ny, nx)))
    uo = 0.1 * np.cos(2 * np.pi * jj / ny)
    vo = 0.05 * np.sin(2 * np.pi * ii / nx)
    prep = dyn_prep(
        g, cfg.dynamics, 3600.0, aice=T(aice), vice=T(vice),
        vsno=T(aice * 0.1 * rng.random((ny, nx))),
        aiceU_prev_mask=torch.as_tensor(rng.random((ny, nx)) > 0.3,
                                        device=cuda),
        uvel=T(0.05 * rng.standard_normal((ny, nx))),
        vvel=T(0.05 * rng.standard_normal((ny, nx))),
        strairxT=T(0.12 * np.sin(2 * np.pi * jj / ny) + 0.06),
        strairyT=T(0.08 * np.cos(2 * np.pi * ii / nx)),
        uocn_T=T(uo), vocn_T=T(vo), ss_tltx_T=T(0 * aice),
        ss_tlty_T=T(0 * aice))
    p = evp_params(cfg.dynamics, 3600.0)
    strength = T(2.75e4 * vice * np.exp(-20.0 * (1.0 - aice)))
    sp, sm, s12 = (T(1e3 * rng.standard_normal((4, ny, nx)))
                   for _ in range(3))
    return (g, p, prep, strength, sp, sm, s12), dict(uocn=T(uo), vocn=T(vo))


EVP_OUT = ("uvel", "vvel", "stressp", "stressm", "stress12", "strintx",
           "strinty", "taubx", "tauby")


_unpack = kevp.unpack_outputs


@pytest.mark.parametrize("ndte", [1, 39, 40])
@pytest.mark.parametrize("route,tile", [
    ("persistent", None),          # the chooser's tile
    ("persistent", (8, 10)),       # many ragged tiles
    ("persistent", (7, 9)),        # 29 rows: a tile row of one cell
    ("persistent", (16, 48)),      # one tile column, wrapped on itself
    ("persistent", (2, 3)),        # tiles that are all perimeter
    ("stream", None)])
@pytest.mark.parametrize("ny,nx,ew", [(40, 48, "cyclic"), (29, 37, "open"),
                                      (29, 37, "cyclic")])
def test_evp_routes_match_plain_exactly(cuda, ny, nx, ew, route, tile, ndte):
    """Both routes repeat the plain version's arithmetic (-fmad=false): all
    nine outputs are equal bit for bit, for odd and even ndte and ndte=1."""
    if tile == (2, 3) and ny * nx > 132 * 6:
        tile = (ny // 8 + 1, nx // 8 + 1)      # at most 64 resident blocks
    args, kw = _evp_problem(cuda, ny, nx, ew, ndte)
    if route == "persistent" and tile is None:
        info = kevp.device_info(0)
        r, tile = kevp.choose_route(ny, nx, info["sm_count"],
                                    info["smem_per_block"],
                                    info["blocks_per_sm"])
        assert r == "persistent"
    ref = evp_solve(*args, **kw)
    before = kevp.persistent_launches, kevp.stream_launches
    got = _unpack(kevp.evp_solve_cuda(*args, **kw, route=route, tile=tile))
    torch.cuda.synchronize()
    assert (kevp.persistent_launches - before[0],
            kevp.stream_launches - before[1]) == \
        ((1, 0) if route == "persistent" else (0, 1))
    assert float(torch.sqrt(ref[0] ** 2 + ref[1] ** 2).max()) > 1e-3
    for name, a, r in zip(EVP_OUT, got, ref):
        assert float((a - r).abs().max()) == 0.0, name


@pytest.mark.parametrize("name,ny,nx", [("gx3", 116, 100),
                                        ("tx1", 240, 360)])
def test_evp_chooser_tiles_at_production_sizes(cuda, name, ny, nx):
    """The wrapper's own route and tile on grids of the gx3 and tx1 sizes:
    persistent, and equal to the plain version bit for bit."""
    args, kw = _evp_problem(cuda, ny, nx, "cyclic", 3)
    before = kevp.persistent_launches
    got = kevp.evp_solve_fused(*args, **kw)
    ref = evp_solve(*args, **kw)
    torch.cuda.synchronize()
    assert kevp.persistent_launches == before + 1, name
    for out, a, r in zip(EVP_OUT, got, ref):
        assert float((a - r).abs().max()) == 0.0, (name, out)


def test_evp_solves_back_to_back(cuda):
    """Two persistent solves in a row on one stream, then a third on other
    inputs, with no synchronisation between: barrier and ring state of one
    solve must not leak into the next."""
    a1, k1 = _evp_problem(cuda, 40, 48, "cyclic", 40, seed=1)
    a2, k2 = _evp_problem(cuda, 40, 48, "cyclic", 39, seed=2)
    outs = [kevp.evp_solve_fused(*a1, **k1), kevp.evp_solve_fused(*a1, **k1),
            kevp.evp_solve_fused(*a2, **k2), kevp.evp_solve_fused(*a1, **k1)]
    torch.cuda.synchronize()
    refs = [evp_solve(*a1, **k1), evp_solve(*a2, **k2)]
    for got, ref in zip(outs, (refs[0], refs[0], refs[1], refs[0])):
        for name, a, r in zip(EVP_OUT, got, ref):
            assert float((a - r).abs().max()) == 0.0, name


def test_evp_all_land_and_ice_free_tiles(cuda):
    """Tiles with no ice at all still meet every barrier and write zeros."""
    args, kw = _evp_problem(cuda, 40, 48, "cyclic", 5)
    g, p, prep, strength, sp, sm, s12 = args
    import dataclasses
    keep = torch.zeros(g.shape, dtype=torch.bool, device=cuda)
    keep[20:, 24:] = True                   # ice in one quadrant only
    prep = dataclasses.replace(
        prep, iceTmask=prep.iceTmask & keep, iceUmask=prep.iceUmask & keep,
        uvel=prep.uvel * keep, vvel=prep.vvel * keep)
    args = (g, p, prep, strength, sp, sm, s12)
    ref = evp_solve(*args, **kw)
    got = _unpack(kevp.evp_solve_cuda(*args, **kw, route="persistent",
                                      tile=(10, 12)))
    torch.cuda.synchronize()
    assert float(ref[0][:20].abs().max()) == 0.0
    for name, a, r in zip(EVP_OUT, got, ref):
        assert float((a - r).abs().max()) == 0.0, name


def test_evp_persistent_launch_that_does_not_fit_raises(cuda):
    """More tiles than the card keeps resident: the cooperative launch is
    refused and the wrapper raises; it never drops to the stream route."""
    args, kw = _evp_problem(cuda, 40, 48, "cyclic", 2)
    before = kevp.launches
    with pytest.raises(RuntimeError):
        kevp.evp_solve_cuda(*args, **kw, route="persistent", tile=(1, 1))
    assert kevp.launches == before
    with pytest.raises(ValueError):
        kevp.evp_solve_cuda(*args, **kw, route="auto")


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
    _fluxes_exact(got, ref)
    _fluxes_exact(alone, ref)


FLUX_OUT = ("mflxe", "mflxn", "mtflxe", "mtflxn")


def _fluxes_exact(got, ref):
    """K3 repeats its plain version's arithmetic (-fmad=false): all four
    outputs equal bit for bit, signed zeros included."""
    assert max(float(r.abs().max()) for r in ref) > 0
    for name, a, r in zip(FLUX_OUT, got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        torch.testing.assert_close(a, r, rtol=0, atol=0)
        assert float((a - r).abs().max()) == 0.0, name
        assert torch.equal(a.view(torch.int32), r.view(torch.int32)), name


def _flux_problem(cuda, table, ncat, ny, nx, seed, ew="cyclic", patch=None):
    """K3's inputs after `construct_fields` on random ice moving at up to
    0.3 cells per hour (only inside `patch`, a (j0, j1, i0, i1) box, when
    given); ((args), tstack)."""
    from cice_tpu_torch.core.grid import rectgrid
    from cice_tpu_torch.core.halo import BC
    from cice_tpu_torch.measure import flux_case
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *s: torch.rand(*s, generator=gen).to(cuda)
    g = rectgrid(nx, ny, kmt_type="default", bc=BC(ew, "open"), device=cuda)
    aicen = 0.3 * rnd(ncat, ny, nx) * g.hm
    am = torch.cat([1.0 - aicen.sum(0, keepdim=True), aicen]).contiguous()
    trm = (2.0 * rnd(ncat, len(table), ny, nx) - 0.5).contiguous()
    move = torch.ones(ny, nx, device=cuda)
    if patch is not None:
        move.zero_()
        move[patch[0]:patch[1], patch[2]:patch[3]] = 1.0
    u = 0.3 * g.dxU / 3600.0 * (2.0 * rnd(ny, nx) - 1.0) * move
    v = 0.3 * g.dyU / 3600.0 * (2.0 * rnd(ny, nx) - 1.0) * move
    dxs, dys, _ = rx.departure_points_scaled(g, u, v, 3600.0, True)
    mom_n, mom_e = (t.contiguous() for t in rx.edge_moments(g, dxs, dys))
    return flux_case(g, mom_n, mom_e, am, trm, table)


def _default_table(cuda):
    return rx.build_flat_table(Model(tconfig.gx1pop_dyn(48, 40),
                                     device=cuda).static.registry)


@pytest.mark.parametrize("ny,nx,ew,how", [
    (37, 70, "cyclic", {}),              # ragged in y and x
    (37, 70, "open", {}),
    (6, 20, "cyclic", {}),               # narrower than one tile
    (8, 32, "open", {}),                 # exactly one 32x8 tile
    (9, 33, "cyclic", {}),               # one cell over, rows not 16 B
    (37, 70, "cyclic", dict(chunk=4)),   # 79 plane groups: chunks of 4
    (37, 70, "cyclic", dict(chunk=16)),  # and 16 end ragged too
    (9, 33, "open", dict(chunk=1))])
def test_tracer_fluxes_kernel_ragged_grids_exact(cuda, ny, nx, ew, how):
    """The default 25-tracer table on grids that do not fill their tiles,
    cyclic and open east-west, staged 8 plane groups per barrier and 1, 4
    or 16."""
    table = _default_table(cuda)
    args, tstack = _flux_problem(cuda, table, 3, ny, nx, ny * nx, ew)
    before = kremap.flux_launches
    ref = kremap.tracer_fluxes_plain(*args)
    got = kremap.tracer_fluxes_cuda(*args, tstack=tstack, **how)
    torch.cuda.synchronize()
    assert kremap.flux_launches == before + 1
    _fluxes_exact(got, ref)


@pytest.mark.parametrize("ew", ["cyclic", "open"])
def test_tracer_fluxes_kernel_dense_case_exact(cuda, ew):
    """The dense recipe of the measurements (`measure.dense_transport_case`:
    ice moving everywhere) on a 5-category grid of 72x96."""
    from cice_tpu_torch.core.grid import rectgrid
    from cice_tpu_torch.core.halo import BC
    from cice_tpu_torch.measure import dense_transport_case, flux_case
    table = _default_table(cuda)
    g = rectgrid(96, 72, kmt_type="default", bc=BC(ew, "open"), device=cuda)
    case = dense_transport_case(g, table, 5, cuda)
    active, needed = kremap.work_fractions(*case[:3])
    assert active > 1.0 and needed > 0.6
    args, tstack = flux_case(*case)
    ref = kremap.tracer_fluxes_plain(*args)
    got = kremap.tracer_fluxes_fused(*args, tstack=tstack)
    torch.cuda.synchronize()
    _fluxes_exact(got, ref)


@pytest.mark.parametrize("nlay", [30, 120])
def test_tracer_fluxes_kernel_large_tables(cuda, nlay):
    """Any NT (35 and 125 tracers, few of them with dependents) on a grid
    ragged in both directions, staged a tracer at a time."""
    from cice_tpu_torch.model.state import DEP_AICE, DEP_VICE, TracerSpec
    reg = (TracerSpec("alvl", DEP_AICE, hi=1.0),
           TracerSpec("apnd", DEP_AICE, parent="alvl", hi=1.0),
           TracerSpec("hpnd", DEP_AICE, parent="apnd"),
           TracerSpec("wide", DEP_VICE, nlay, lo=-1.0, hi=1.0))
    table = rx.build_flat_table(reg)
    assert len(table) == nlay + 5
    args, tstack = _flux_problem(cuda, table, 3, 37, 70, nlay)
    ref = kremap.tracer_fluxes_plain(*args)
    got = kremap.tracer_fluxes_fused(*args, tstack=tstack)
    torch.cuda.synchronize()
    _fluxes_exact(got, ref)


@pytest.mark.parametrize("nx", [68, 70])
def test_tracer_fluxes_kernel_still_tiles_exact(cuda, nx):
    """Ice moving in one patch: most tiles have no candidate with a moment
    and write their signed zeros whole (16-byte rows where nx is a multiple
    of 4, single values where it is not)."""
    table = _default_table(cuda)
    args, tstack = _flux_problem(cuda, table, 3, 40, nx, nx,
                                 patch=(12, 20, 30, 45))
    active, needed = kremap.work_fractions(*args[:3])
    assert 0.0 < active < 0.5 and 0.0 < needed < 0.2
    ref = kremap.tracer_fluxes_plain(*args)
    got = kremap.tracer_fluxes_fused(*args, tstack=tstack)
    torch.cuda.synchronize()
    _fluxes_exact(got, ref)
    assert bool(torch.signbit(got[3][:, :, :8]).all())   # (-0) * area


def test_tracer_fluxes_kernel_never_reads_a_cell_that_donates_nothing(cuda):
    """A NaN reconstruction (tracer and mass) in a cell that no candidate
    with a moment takes from: the kernel never loads it, so its fluxes stay
    finite and equal, bit for bit, the plain version's on the same fields
    with that cell made finite; the plain version hands the NaN to the
    fluxes of the edges around the cell (0 * NaN). The update that follows
    keeps the NaN in the cell on both paths (kremap.work_fractions)."""
    table = _default_table(cuda)
    args, tstack = _flux_problem(cuda, table, 3, 20, 26, 7,
                                 patch=(6, 12, 8, 16))
    g, mom_n, mom_e = args[:3]
    act_n = (mom_n != 0).any(dim=1)
    act_e = (mom_e != 0).any(dim=1)
    need = torch.zeros(g.shape, dtype=torch.bool, device=cuda)
    for act, offs in ((act_n, rx.OFFS_N), (act_e, rx.OFFS_E)):
        for ci, (dj, di) in enumerate(offs):
            need |= rx._shs(act[ci].float(), -dj, -di, g.bc) > 0
    j0, i0 = 16, 3
    assert not bool(need[j0, i0]) and bool(need.any())
    NT = len(table)
    n0 = next(n for n, f in enumerate(table) if f.ttype == 1)

    def planted(value):
        ts, mc, mx, my = (t.clone() for t in (tstack, *args[3:6]))
        for k in (n0, NT + n0, 2 * NT + n0):
            ts[1, k, j0, i0] = value
        for t in (mc, mx, my):
            t[2, j0, i0] = value
        ta = (ts[:, :NT], ts[:, NT:2 * NT], ts[:, 2 * NT:])
        return (*args[:3], mc, mx, my, *ta, table), ts

    nan_args, nan_ts = planted(float("nan"))
    fin_args, _ = planted(0.0)
    ref_nan = kremap.tracer_fluxes_plain(*nan_args)
    ref_fin = kremap.tracer_fluxes_plain(*fin_args)
    got = kremap.tracer_fluxes_fused(*nan_args, tstack=nan_ts)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(ref_nan[3]).all())    # the plain spreads
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _fluxes_exact(got, ref_fin)
    for a, r in zip(got, ref_nan):
        ok = torch.isfinite(r)
        assert torch.equal(a[ok], r[ok])


def test_tracer_fluxes_kernel_info(cuda):
    info = kremap.flux_kernel_info()
    assert info["tile"] == (32, 2) and info["threads"] == 128
    assert info["smem"] >= kremap.flux_smem_bytes()
    assert info["blocks_per_sm"] >= 1 and 0 < info["registers"] <= 128


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
    """Any NT: a wide tracer table runs in more chunks of the same size on
    the same 32x8 tile (few of its tracers have dependents) and must still
    match the plain version, on a grid ragged in both directions."""
    from cice_tpu_torch.model.state import DEP_AICE, DEP_VICE, TracerSpec
    reg = (TracerSpec("alvl", DEP_AICE, hi=1.0),
           TracerSpec("apnd", DEP_AICE, parent="alvl", hi=1.0),
           TracerSpec("hpnd", DEP_AICE, parent="apnd"),
           TracerSpec("wide", DEP_VICE, nlay, lo=-1.0, hi=1.0))
    table = rx.build_flat_table(reg)
    NT, ncat, ny, nx = len(table), 3, 37, 70
    sch = kremap.build_schedule(table)
    assert kremap.pick_tile(kremap.pack_schedule(table, sch).layout) == \
        (32, 8)
    assert len(sch.ch_nw1) >= NT // kremap.CHUNK
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


def _transport_problem(cuda, table, ncat, ny, nx, seed):
    from cice_tpu_torch.core.grid import rectgrid
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *s: torch.rand(*s, generator=gen).to(cuda)
    g = rectgrid(nx, ny, kmt_type="default", device=cuda)
    NT = len(table)
    aicen = 0.3 * rnd(ncat, ny, nx) * g.hm
    am = torch.cat([1.0 - aicen.sum(0, keepdim=True), aicen]).contiguous()
    trm = (2.0 * rnd(ncat, NT, ny, nx) - 0.5).contiguous()
    u = 0.3 * g.dxU / 3600.0 * (2.0 * rnd(ny, nx) - 1.0)
    v = 0.3 * g.dyU / 3600.0 * (2.0 * rnd(ny, nx) - 1.0)
    dxs, dys, _ = rx.departure_points_scaled(g, u, v, 3600.0, True)
    mom_n, mom_e = (t.contiguous() for t in rx.edge_moments(g, dxs, dys))
    return g, mom_n, mom_e, am, trm, table


@pytest.mark.parametrize("ny,nx", [(37, 70),      # ragged in y and x
                                   (5, 20),       # narrower than one tile
                                   (8, 32),       # exactly one tile
                                   (9, 33)])      # one cell over
def test_transport_kernel_ragged_grids_exact(cuda, ny, nx):
    """The default 25-tracer table on grids that do not fill their tiles;
    the kernel repeats the plain version's arithmetic, so the results are
    equal bit for bit."""
    table = rx.build_flat_table(Model(tconfig.gx1pop_dyn(48, 40),
                                      device=cuda).static.registry)
    args = _transport_problem(cuda, table, 3, ny, nx, seed=ny * nx)
    before = kremap.launches
    ref_am, ref_trm = kremap.transport_plain(*args)
    got_am, got_trm = kremap.transport_fused(*args)
    torch.cuda.synchronize()
    assert kremap.launches == before + 1
    assert float(ref_trm.abs().max()) > 0.1
    assert float((got_am - ref_am).abs().max()) == 0.0
    assert float((got_trm - ref_trm).abs().max()) == 0.0


def test_transport_kernel_keeps_a_nan_where_nothing_moves(cuda):
    """A NaN tracer in a cell that donates nothing (no moment on any edge
    around it): the kernel leaves out the candidates without a moment, so
    the NaN stays in its cell; the plain version multiplies it by those
    zero moments and hands it to the neighbours. Wherever the plain version
    stays finite the two still agree bit for bit, and the cell itself is
    not finite in both, so `check_state` flags the state either way."""
    table = rx.build_flat_table(Model(tconfig.gx1pop_dyn(48, 40),
                                      device=cuda).static.registry)
    ncat, ny, nx = 3, 20, 26
    g, _, _, am, trm, _ = _transport_problem(cuda, table, ncat, ny, nx, 7)
    gen = torch.Generator(device="cpu").manual_seed(8)
    rnd = lambda *s: torch.rand(*s, generator=gen).to(cuda)
    patch = torch.zeros(ny, nx, device=cuda)
    patch[6:12, 8:16] = 1.0                # the ice moves only here
    u = 0.3 * g.dxU / 3600.0 * (2.0 * rnd(ny, nx) - 1.0) * patch
    v = 0.3 * g.dyU / 3600.0 * (2.0 * rnd(ny, nx) - 1.0) * patch
    dxs, dys, _ = rx.departure_points_scaled(g, u, v, 3600.0, True)
    mom_n, mom_e = (t.contiguous() for t in rx.edge_moments(g, dxs, dys))
    active, needed = kremap.work_fractions(g, mom_n, mom_e)
    assert 0.0 < active < 1.0 and 0.0 < needed < 0.5
    n0 = next(n for n, f in enumerate(table)     # a tracer without children
              if f.ttype == 1 and not f.has_dependents)
    j0, i0 = 16, 3
    assert float(g.hm[j0, i0]) == 1.0
    trm = trm.clone()
    trm[1, n0, j0, i0] = float("nan")
    ref_am, ref_trm = kremap.transport_plain(g, mom_n, mom_e, am, trm, table)
    got_am, got_trm = kremap.transport_fused(g, mom_n, mom_e, am, trm, table)
    torch.cuda.synchronize()
    bad_ref, bad_got = ~torch.isfinite(ref_trm), ~torch.isfinite(got_trm)
    assert bool(bad_got[1, n0, j0, i0]) and bool(bad_ref[1, n0, j0, i0])
    here = torch.zeros_like(bad_got)
    here[1, n0, j0, i0] = True
    assert not bool((bad_got & ~here).any())       # it stays in its cell
    assert int(bad_ref.sum()) > int(bad_got.sum())  # the plain one spreads
    assert not bool((bad_got & ~bad_ref).any())
    assert torch.equal(got_trm[~bad_ref], ref_trm[~bad_ref])
    assert bool(torch.isfinite(got_am).all())
    assert torch.equal(got_am[torch.isfinite(ref_am)],
                       ref_am[torch.isfinite(ref_am)])


def test_transport_kernel_info(cuda):
    table = rx.build_flat_table(Model(tconfig.gx1pop_dyn(48, 40),
                                      device=cuda).static.registry)
    info = kremap.kernel_info(table)
    assert info["tile"] == (32, 8) and info["threads"] == 576
    assert info["blocks_per_sm"] >= 1 and 0 < info["registers"] <= 112


# ---------------------------------------------------------------------------
# where a kernel cannot take the grid or the dtype, the wrappers and the
# dispatchers above them raise on the card; a run names the plain engines
# to get them there
# ---------------------------------------------------------------------------

def _launches():
    return (kevp.launches, kremap.launches, kremap.flux_launches)


@pytest.mark.parametrize("ns", ["tripole", "cyclic"])
def test_evp_raises_on_tripole_and_y_cyclic(cuda, ns):
    import dataclasses
    from cice_tpu_torch.core.halo import BC
    args, kw = _evp_problem(cuda, 40, 48, "cyclic", 10)
    g = dataclasses.replace(args[0], bc=BC("cyclic", ns))
    args = (g,) + args[1:]
    before = _launches()
    for solve in (kevp.evp_solve_fused, kevp.evp_solve_cuda):
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            solve(*args, **kw)
    torch.cuda.synchronize()
    assert _launches() == before


def test_evp_raises_on_float64(cuda):
    """K1 is float32; f64 inputs raise rather than being rounded to f32
    (the JAX package's fused solve casts them)."""
    args, kw = _evp_problem(cuda, 40, 48, "cyclic", 10)
    g, p, prep, *stresses = args
    import dataclasses
    as64 = lambda o: dataclasses.replace(o, **{
        f.name: getattr(o, f.name).double()
        for f in dataclasses.fields(o)
        if isinstance(getattr(o, f.name), torch.Tensor)
        and getattr(o, f.name).is_floating_point()})
    args64 = (g, p, as64(prep)) + tuple(t.double() for t in stresses)
    kw64 = {k: v.double() for k, v in kw.items()}
    before = _launches()
    with pytest.raises(ValueError, match="f32-only"):
        kevp.evp_solve_fused(*args64, **kw64)
    assert _launches() == before


@pytest.mark.parametrize("case", ["tripole", "y_cyclic", "float64"])
@pytest.mark.parametrize("fk", ["fused_pallas", "fused_full"])
def test_transport_raises_where_the_kernels_cannot_go(cuda, case, fk):
    import dataclasses
    from cice_tpu_torch.core.halo import BC
    over = {"dynamics.evp_algorithm": "standard_2d"}
    if case == "float64":
        over["dtype"] = "float64"
    m = Model(tconfig.gx1pop_dyn(48, 40).with_overrides(**over), device=cuda)
    dt = m.cfg.setup.dt
    st, _ = step_dyn_horiz(m.static, m.grid, m.state, m.forcing,
                           m.forcing.strax + 0.1, m.forcing.stray + 0.05, dt)
    ns = {"tripole": "tripole", "y_cyclic": "cyclic"}.get(case, "open")
    g = dataclasses.replace(m.grid, bc=BC("cyclic", ns))
    exc, what = ((ValueError, "float32") if case == "float64" else
                 (NotImplementedError, "ROADMAP A9"))
    before = _launches()
    with pytest.raises(exc, match=what):
        rx.horizontal_remap_exact(g, st, m.static.registry, m.forcing.Tf, dt,
                                  flux_kernel=fk, l_dp_midpt=True)
    torch.cuda.synchronize()
    assert _launches() == before


def test_y_cyclic_model_raises_with_kernels_and_steps_on_named_plain_engines(
        cuda):
    """gx1pop_step with ns_boundary_type='cyclic': with K1 and K3 asked for,
    the step raises naming ROADMAP A9; with the plain engines named it
    runs and launches no kernel."""
    over = {"dynamics.ndte": 20, "grid.ns_boundary_type": "cyclic"}
    m = Model(tconfig.gx1pop_step(48, 40).with_overrides(**over),
              device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        m.step()
    m = Model(tconfig.gx1pop_step(48, 40).with_overrides(**over, **{
        "dynamics.evp_algorithm": "standard_2d",
        "dynamics.remap_kernel": "xla"}), device=cuda)
    before = _launches()
    m.step()
    torch.cuda.synchronize()
    assert _launches() == before
    assert bool(torch.isfinite(m.state.aicen).all())


# ---------------------------------------------------------------------------
# C and CD grids: K2 and K3 on moments with the Bentsen edge areas, a
# gridc restart, and the VP solver without host reads
# ---------------------------------------------------------------------------

def _cgrid_moments(cuda, grid_ice, nx=48, ny=40):
    """One C- or CD-grid EVP solve on gx1pop_dyn's grid, then the edge
    moments of the exact remap from the face velocities (corner means and
    Bentsen edge areas): (model, state, (mom_n, mom_e))."""
    cfg = tconfig.gx1pop_dyn(nx, ny).with_overrides(**{
        "grid.grid_ice": grid_ice})
    m = Model(cfg, device=cuda)
    g, dt = m.grid, cfg.setup.dt
    st, _ = step_dyn_horiz(m.static, g, m.state, m.forcing,
                           m.forcing.strax + 0.1, m.forcing.stray + 0.05, dt)
    assert float(st.uvelE.abs().max()) > 1e-3
    uc, vc, ea_e, ea_n = rx.corner_velocities_and_edge_areas(g, st,
                                                             grid_ice, dt)
    dxs, dys, _ = rx.departure_points_scaled(g, uc, vc, dt, True)
    moms = tuple(t.contiguous() for t in rx.edge_moments(g, dxs, dys, ea_e,
                                                          ea_n))
    return m, st, moms


@pytest.mark.parametrize("size", [(48, 40), (320, 384)], ids=["small", "gx1"])
@pytest.mark.parametrize("grid_ice", ["C", "CD"])
def test_kernels_on_c_grid_moments_exact(cuda, grid_ice, size):
    """K2 and K3 take the moments as they come: on C- and CD-grid moments
    both equal their plain versions bit for bit."""
    m, st, (mom_n, mom_e) = _cgrid_moments(cuda, grid_ice, *size)
    g = m.grid
    table = rx.build_flat_table(m.static.registry)
    am, trm = rx.state_to_tracers(st, m.static.registry, table)
    before = (kremap.launches, kremap.flux_launches)
    ref_am, ref_trm = kremap.transport_plain(g, mom_n, mom_e, am, trm, table)
    got_am, got_trm = kremap.transport_fused(g, mom_n, mom_e, am, trm, table)
    mc, mx, my, tc, tx, ty, tstack = rx.construct_fields(g, am, trm, table,
                                                         g.hm)
    args = (g, mom_n, mom_e, mc, mx, my, tc, tx, ty, table)
    ref = kremap.tracer_fluxes_plain(*args)
    got = kremap.tracer_fluxes_fused(*args, tstack=tstack)
    torch.cuda.synchronize()
    assert (kremap.launches, kremap.flux_launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert float((got_am - ref_am).abs().max()) == 0.0
    assert float((got_trm - ref_trm).abs().max()) == 0.0
    _fluxes_exact(got, ref)


def test_gridc_run_continues_bit_for_bit_on_the_card(cuda, tmp_path):
    """gridc through K2 ('auto'): a run continued from a restart equals the
    uninterrupted run bit for bit."""
    import os
    import shutil
    from cice_tpu_torch.model.state import state_leaves
    restart = os.path.join(str(tmp_path), "restart")
    cfg = tconfig.gx1pop_step(48, 40, remap_kernel="auto").with_overrides(**{
        "grid.grid_ice": "C", "dynamics.ndte": 40, "setup.dumpfreq": "1",
        "setup.dumpfreq_n": 2, "setup.restart_dir": restart,
        "setup.pointer_file": os.path.join(restart, "ice.restart_file")})
    before = kremap.launches
    a = Model(cfg, device=cuda)
    a.run(2)
    ptr = shutil.copy(cfg.setup.pointer_file,
                      os.path.join(str(tmp_path), "pointer"))
    a.run(2)
    assert kremap.launches == before + 4
    b = Model(cfg.with_overrides(**{"setup.runtype": "continue",
                                    "setup.pointer_file": ptr}), device=cuda)
    b.run(2)
    for x, y in zip(state_leaves(a.state), state_leaves(b.state)):
        assert torch.equal(x, y)
    assert float(a.state.uvelE.abs().max()) > 1e-3


@pytest.mark.parametrize("algo", ["picard", "anderson"])
def test_vp_solver_reads_nothing_on_the_host(cuda, algo):
    """implicit_solver on the card under sync debug mode 'error': any
    host synchronisation inside it raises."""
    from cice_tpu_torch.dynamics.vp import implicit_solver
    cfg = tconfig.gx1pop_dyn(48, 40).with_overrides(**{
        "dynamics.kdyn": 3, "dynamics.algo_nonlin": algo,
        "dynamics.maxits_nonlin": 3, "dynamics.dim_fgmres": 10,
        "dynamics.maxits_fgmres": 20, "dynamics.dim_pgmres": 3,
        "dynamics.maxits_pgmres": 3})
    m = Model(cfg, device=cuda)
    g, d, dt = m.grid, cfg.dynamics, cfg.setup.dt
    s, fc = m.state, m.forcing
    prep = dyn_prep(g, d, dt, aice=s.aice, vice=s.vice, vsno=s.vsno,
                    aiceU_prev_mask=s.iceUmask, uvel=s.uvel, vvel=s.vvel,
                    strairxT=fc.strax + 0.1, strairyT=fc.stray + 0.05,
                    uocn_T=fc.uocn, vocn_T=fc.vocn, ss_tltx_T=fc.ss_tltx,
                    ss_tlty_T=fc.ss_tlty)
    strength = ice_strength(s.aicen, s.vicen, s.aice, s.vice, d)
    z = torch.zeros_like(s.aice)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = implicit_solver(g, d, prep, strength, uocn=z, vocn=z, dt=dt)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(out[0]).all())
    assert float(out[0].abs().max()) > 1e-3


def test_eap_on_the_card_against_the_cpu(cuda):
    """One EAP dynamics step at 48x40 (ndte=120, f32) on the card and on
    the CPU from the same state. The lookup truncates a float ratio to a
    table index, so a one-ulp difference (atan2, sqrt and exp differ
    between the two math libraries) may pick a neighbouring entry: the
    test prints how far the two move apart and holds them within 1e-1 of
    the largest velocity."""
    cfg = tconfig.gx1pop_dyn(48, 40).with_overrides(**{"dynamics.kdyn": 2})
    outs = []
    for dev in ("cpu", cuda):
        m = Model(cfg, device=dev)
        fc = m.forcing
        st, dyn = step_dyn_horiz(m.static, m.grid, m.state, fc,
                                 fc.strax + 0.1, fc.stray + 0.05,
                                 cfg.setup.dt)
        outs.append({k: getattr(st, k).cpu() for k in
                     ("uvel", "vvel", "stressp", "a11", "a12")})
    rel = {k: float((outs[1][k] - outs[0][k]).abs().max()) /
           max(float(outs[0][k].abs().max()), 1e-30) for k in outs[0]}
    print(f"EAP card against CPU after one step, max |diff| / max |CPU|: "
          f"{rel}")
    assert all(bool(torch.isfinite(v).all()) for v in outs[1].values())
    assert float(outs[0]["uvel"].abs().max()) > 1e-3
    assert rel["uvel"] < 1e-1 and rel["vvel"] < 1e-1


# ---------------------------------------------------------------------------
# K4: therm1's BL99 temperature solve (kernels/bl99.py) against the plain
# version, bit for bit in every output and in the pass count
# ---------------------------------------------------------------------------

def _therm1_args(cuda, nx=320, ny=384, over=None, edit=None):
    """The arguments step_therm1 hands `temperature_changes` on the first
    step of gx1pop_step(nx, ny) on the card (`measure.therm1_problem`)."""
    from cice_tpu_torch.measure import therm1_problem
    m = Model(tconfig.gx1pop_step(nx, ny).with_overrides(**(over or {})),
              device=cuda)
    out = therm1_problem(m, edit)
    torch.cuda.synchronize()
    return out


@pytest.fixture(scope="module")
def gx1_therm1(cuda):
    return _therm1_args(cuda)


def _flat(out):
    ts, qsno_new, qice_new = out[:3]
    names, vals = [], []
    for f, v in zip(ts._fields, ts):
        v = v if isinstance(v, list) else [v]
        names += [f"{f}[{i}]" for i in range(len(v))]
        vals += v
    names += [f"qsno_new[{i}]" for i in range(len(qsno_new))]
    names += [f"qice_new[{i}]" for i in range(len(qice_new))]
    return names, vals + list(qsno_new) + list(qice_new)


def _k4_against_plain(dt, nilyr, nslyr, kw, route="whole"):
    """K4 and `temperature_changes_plain` on the same arguments: every
    output equal bit for bit (signed zeros and NaNs included). Returns
    (the plain version's passes, K4's passes, the plain outputs)."""
    from cice_tpu_torch.columns import thermo_vertical as tv
    from cice_tpu_torch.kernels import bl99 as kbl99
    from cice_tpu_torch.utils.timers import sync_counts
    reads = sync_counts().get("picard", 0)
    ref = tv.temperature_changes_plain(dt, nilyr, nslyr, **kw)
    torch.cuda.synchronize()
    passes = sync_counts().get("picard", 0) - reads
    got = kbl99.temperature_changes_cuda(dt, nilyr, nslyr, route=route, **kw)
    names, g = _flat(got)
    _, r = _flat(ref)
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}
    bad = {}
    for n, a, b in zip(names, g, r):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(
                a.contiguous().view(bits[b.dtype]),
                b.contiguous().view(bits[b.dtype])):
            bad[n] = float((a - b).abs().nan_to_num(float("inf")).max())
    assert len(names) == len(r) and not bad, \
        f"K4 differs from the plain version (max abs): {bad}"
    return passes, int(got[3]), ref


@pytest.mark.parametrize("conduct", ["bubbly", "MU71"])
def test_k4_equals_plain_on_gx1pop(cuda, gx1_therm1, conduct):
    from cice_tpu_torch import constants as cst
    dt, nilyr, nslyr, kw = gx1_therm1
    snow = kw["hslyr"] * nslyr > cst.hs_min
    assert bool(snow.any()) and bool((~snow).any())
    passes, npass, ref = _k4_against_plain(dt, nilyr, nslyr,
                                           dict(kw, conduct=conduct))
    assert npass == passes >= 2


def test_k4_equals_plain_at_om025_size(cuda, gx1_therm1):
    """The gx1pop columns tiled to 5 x 1080 x 1440 (om025's 7.8 M)."""
    dt, nilyr, nslyr, kw = gx1_therm1

    def big(t):
        if not isinstance(t, torch.Tensor):
            return [big(x) for x in t] if isinstance(t, list) else t
        reps = (1, 3, 5) if t.dim() == 3 else (3, 5)
        return t.repeat(*reps)[..., :1080, :1440].contiguous()
    kw = {k: big(v) for k, v in kw.items()}
    assert kw["Tsf"].shape == (5, 1080, 1440)
    passes, npass, _ = _k4_against_plain(dt, nilyr, nslyr, kw)
    assert npass == passes >= 2


def test_k4_equals_plain_on_edge_columns(cuda):
    """Vanishing ice (aicen 1e-10, thinner than hi_min), snow below and
    above hs_min on it, a band whose surface melts, surfaces below the
    -100 C window."""
    import dataclasses
    from cice_tpu_torch import constants as cst

    def edit(st):
        a, v, s = st.aicen.clone(), st.vicen.clone(), st.vsnon.clone()
        a[:, 180:190], v[:, 180:190] = 1e-10, 1e-10 * 0.03
        s[:, 180:185], s[:, 185:190] = 1e-10 * 5e-5, 1e-10 * 0.2
        return dataclasses.replace(st, aicen=a, vicen=v, vsnon=s)
    dt, nilyr, nslyr, kw = _therm1_args(cuda, edit=edit)
    # a melting surface: far more sunshine on half of the thick ice
    thick = kw["hilyr"] * nilyr > 0.5
    thick[..., ::2] = False
    kw["fswsfc"] = torch.where(thick, kw["fswsfc"] + 4000.0, kw["fswsfc"])
    kw["Tsf"] = kw["Tsf"].clone()
    kw["Tsf"][:, 20:24] = -150.0
    hs = kw["hslyr"] * nslyr
    assert bool(((hs > 0) & (hs <= cst.hs_min)).any())
    assert bool((hs > cst.hs_min).any())
    passes, npass, ref = _k4_against_plain(dt, nilyr, nslyr, kw)
    assert npass == passes
    assert bool((ref[0].Tsf == 0.0).any()), "no surface melts"
    assert bool((ref[0].Tsf < -5.0).any())


@pytest.mark.parametrize("errmax,nit,want", [(1e30, 20, 1), (-1.0, 5, 5),
                                             (-1.0, 0, 0)],
                         ids=["exit_at_pass_1", "reaches_nit", "nit_0"])
def test_k4_exit_where_the_plain_loop_exits(cuda, gx1_therm1, monkeypatch,
                                            errmax, nit, want):
    from cice_tpu_torch.columns import thermo_vertical as tv
    monkeypatch.setattr(tv, "TSF_ERRMAX", errmax)
    dt, nilyr, nslyr, kw = gx1_therm1
    passes, npass, _ = _k4_against_plain(dt, nilyr, nslyr,
                                         dict(kw, nit=nit))
    assert npass == passes == want


def test_k4_equals_plain_in_float64(cuda, gx1_therm1):
    dt, nilyr, nslyr, kw = gx1_therm1
    f64 = lambda v: ([x.double() for x in v] if isinstance(v, list) and
                     isinstance(v[0], torch.Tensor) else
                     v.double() if isinstance(v, torch.Tensor) else v)
    passes, npass, _ = _k4_against_plain(
        dt, nilyr, nslyr, {k: f64(v) for k, v in kw.items()})
    assert npass == passes >= 2


@pytest.mark.parametrize("over", [{"domain.nslyr": 3}, {"domain.nslyr": 5},
                                  {"domain.nilyr": 1}],
                         ids=["nslyr3", "nslyr5", "nilyr1"])
def test_k4_equals_plain_on_the_other_built_shapes(cuda, over):
    dt, nilyr, nslyr, kw = _therm1_args(cuda, 48, 40, over)
    passes, npass, _ = _k4_against_plain(dt, nilyr, nslyr, kw)
    assert npass == passes >= 1


def test_k4_shape_not_built_raises_on_the_card(cuda):
    from cice_tpu_torch.kernels import launch_counts
    m = Model(tconfig.gx1pop_step(48, 40).with_overrides(**{
        "domain.nilyr": 4}), device=cuda)
    before = launch_counts()
    with pytest.raises(ValueError, match="not built"):
        m.step()
    assert launch_counts() == before


def test_k4_per_pass_route_equals_plain(cuda, gx1_therm1):
    """The per-pass route (the sharded state's) without a mesh: bit for
    bit, a host read and a launch a pass, one launch for the epilogue."""
    from cice_tpu_torch.kernels import launch_counts
    from cice_tpu_torch.utils.timers import sync_counts
    dt, nilyr, nslyr, kw = gx1_therm1
    launches = launch_counts().get("bl99_per_pass", 0)
    passes, npass, _ = _k4_against_plain(dt, nilyr, nslyr, kw,
                                         route="per_pass")
    assert npass == passes >= 2
    assert launch_counts()["bl99_per_pass"] - launches == passes + 1


def test_k4_per_pass_on_a_1x2_mesh_equals_the_whole_grid(cuda, tmp_path):
    """Two ranks on the card, each K4's per-pass route on its tile with
    the exit agreed across them: the gathered outputs equal the whole
    grid's one launch bit for bit, in as many passes."""
    import test_torch_rank_jobs as rj
    from cice_tpu_torch.kernels import _build
    from cice_tpu_torch.kernels import bl99 as kbl99
    from cice_tpu_torch.parallel import spawn
    _build.build(("bl99_column",))
    dt, nilyr, nslyr, kw = _therm1_args(cuda, 48, 40)
    out = kbl99.temperature_changes_cuda(dt, nilyr, nslyr, **kw)
    ref = [t.cpu().numpy() for t in _flat(out)[1]]
    npass = int(out[3])
    problem = rj.bl99_problem(dt, nilyr, nslyr, kw,
                              str(tmp_path / "bl99.pkl"))
    (r,) = spawn.launch([(rj.bl99_tiles, dict(problem=problem, shape=(1, 2),
                                              device="cuda"), 2)],
                        2, str(tmp_path), timeout=300.0)
    assert len({x["digest"] for x in r}) == 1
    for a, b in zip(r[0]["out"], ref):
        assert a.tobytes() == b.tobytes()
    for x in r:
        assert x["stats"]["picard"] == npass >= 2
        assert x["stats"]["launches"] == {"bl99_per_pass": npass + 1}


def test_k4_model_step_reads_no_picard_and_launches_once(cuda, gx1_therm1,
                                                         monkeypatch):
    """A step without a mesh makes no Picard read and launches K4 once; a
    solve is one launch whatever its passes."""
    from cice_tpu_torch.columns import thermo_vertical as tv
    from cice_tpu_torch.kernels import bl99 as kbl99
    from cice_tpu_torch.kernels import launch_counts
    from cice_tpu_torch.utils.timers import sync_counts
    m = Model(tconfig.gx1pop_step(48, 40), device=cuda)
    reads = sync_counts().get("picard", 0)
    launches = launch_counts().get("bl99_whole", 0)
    m.run(2)
    torch.cuda.synchronize()
    assert sync_counts().get("picard", 0) == reads
    assert launch_counts()["bl99_whole"] - launches == 2
    dt, nilyr, nslyr, kw = gx1_therm1
    for errmax, want in ((1e30, 1), (-1.0, 20)):
        monkeypatch.setattr(tv, "TSF_ERRMAX", errmax)
        before = launch_counts()["bl99_whole"]
        npass = kbl99.temperature_changes_cuda(dt, nilyr, nslyr,
                                               **dict(kw, nit=20))[3]
        assert int(npass) == want
        assert launch_counts()["bl99_whole"] - before == 1


def test_k2_counts_the_tracer_chunks_it_walks(cuda):
    """`kernels.launch_counts()` adds K2's tracer chunks, counted on the
    host from its schedule: 19 a pass at the z tracers' NT 266, 2 at NT
    25 (PERF.md's kernel table)."""
    from cice_tpu_torch.cli.main import OPTION_SETS
    from cice_tpu_torch.kernels import launch_counts
    for over, nch in (({}, 2), (OPTION_SETS["bgcz"], 19)):
        m = Model(tconfig.gx1pop_step(48, 40, remap_kernel="auto")
                  .with_overrides(**over), device=cuda)
        before = launch_counts()
        m.step()
        after = launch_counts()
        assert after["transport_fused"] - before["transport_fused"] == 1
        assert after["transport_chunks"] - before["transport_chunks"] == nch
