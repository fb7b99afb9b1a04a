"""The chunk schedule and the tile choice of the one-pass transport kernel
(cice_tpu_torch/kernels/remap.py `build_schedule`, `pick_tile`,
`smem_bytes`; consumed by csrc/transport_fused.cu), and the tracer order,
shared memory, walk and bound of the flux-only kernel (`flux_order`,
`flux_smem_bytes`, `tracer_fluxes_bound_bytes_flops`; csrc/
tracer_fluxes.cu), checked on the CPU.

The kernel walks the schedule as it stands: per chunk it reconstructs the
entries (types 1 and 3 first, then type 2 from their parents' slots),
fluxes the owned ones, and updates them one chain type after the other
(1, 2, 3), reading each parent's unclipped new value from the slot `vslot`
gives it. `_walk` replays exactly that order and fails
where the kernel would read something not yet written.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch.dynamics import remap_exact as rx  # noqa: E402
from cice_tpu_torch.kernels import remap as kremap  # noqa: E402
from cice_tpu_torch.model.state import (DEP_AICE, DEP_VICE,  # noqa: E402
                                        TracerSpec, tracer_registry)


def _wide_table(nlay):
    reg = (TracerSpec("alvl", DEP_AICE, hi=1.0),
           TracerSpec("apnd", DEP_AICE, parent="alvl", hi=1.0),
           TracerSpec("hpnd", DEP_AICE, parent="apnd"),
           TracerSpec("wide", DEP_VICE, nlay, lo=-1.0, hi=1.0))
    return rx.build_flat_table(reg)


TABLES = {
    "default": lambda: rx.build_flat_table(tracer_registry(tconfig.Config())),
    "nlay30": lambda: _wide_table(30),
    "nlay120": lambda: _wide_table(120),
}


def _walk(table, sch):
    """Replay the kernel's order over the schedule; returns how often each
    tracer was updated."""
    NT = len(table)
    updated = [0] * NT
    have_val = set()
    nch = len(sch.ch_nw1)
    assert len(sch.ch_start) == nch + 1 and sch.ch_start[0] == 0
    assert sch.ch_start[-1] == len(sch.ent_tr)
    for k in range(nch):
        e0, e1 = sch.ch_start[k], sch.ch_start[k + 1]
        ent = sch.ent_tr[e0:e1]
        assert 0 < len(ent) <= sch.chunk and len(set(ent)) == len(ent)
        nw1 = sch.ch_nw1[k]
        for s, n in enumerate(ent):
            f = table[n]
            assert (f.ttype != 2) == (s < nw1), "type 2 after types 1 and 3"
            p, g = sch.ent_p[e0 + s], sch.ent_g[e0 + s]
            if f.ttype == 1:
                assert p == -1 and g == -1
            else:
                assert ent[p] == f.parent, "parent's reconstruction"
                if f.ttype == 2:
                    assert p < nw1 and g == -1   # in place before wave 2
                else:
                    assert ent[g] == table[f.parent].parent
        for wave in (1, 2, 3):           # one chain type after the other
            for s, n in enumerate(ent):
                f = table[n]
                if not sch.ent_own[e0 + s] or f.ttype != wave:
                    continue
                if f.ttype >= 2:
                    assert f.parent in have_val, (f.name, "parent's value")
                    assert sch.vslot[f.parent] >= 0
                if f.ttype == 3:
                    gp = table[f.parent].parent
                    assert gp in have_val and sch.vslot[gp] >= 0
                updated[n] += 1
                if f.has_dependents:
                    have_val.add(n)
    return updated


@pytest.mark.parametrize("budget", [3, 5, kremap.CHUNK])
@pytest.mark.parametrize("name", list(TABLES))
def test_schedule_follows_the_chains(name, budget):
    table = TABLES[name]()
    sch = kremap.build_schedule(table, budget)
    assert _walk(table, sch) == [1] * len(table)      # every tracer once
    assert 2 <= sch.chunk <= budget                   # the plane budget
    slots = [v for v in sch.vslot if v >= 0]
    assert slots == list(range(sch.nslots))
    assert [v >= 0 for v in sch.vslot] == [f.has_dependents for f in table]


def test_default_schedule_is_two_chunks():
    """NT = 25: hi and 15 of its children, then everything else with hi
    once more as an ancestor (26 reconstructions for 25 tracers)."""
    table = TABLES["default"]()
    assert len(table) == 25
    sch = kremap.build_schedule(table)
    assert len(sch.ch_nw1) == 2 and len(sch.ent_tr) == 26
    assert sum(sch.ent_own) == 25 and sch.nslots == 4


def test_schedule_rejects_a_chunk_too_small_for_a_chain():
    with pytest.raises(ValueError):
        kremap.build_schedule(TABLES["default"](), 2)


@pytest.mark.parametrize("name", list(TABLES))
def test_tile_fits_shared_memory_and_the_block(name):
    table = TABLES[name]()
    NT = len(table)
    sch = kremap.build_schedule(table)
    layout = kremap.pack_schedule(table, sch).layout
    assert layout.n <= 27 * NT + 8          # at most 27 ints per tracer
    assert (layout.chunk, layout.nslots) == (sch.chunk, sch.nslots)
    tile = kremap.pick_tile(layout)
    assert kremap.smem_bytes(*tile, layout) <= kremap.MAX_SMEM
    # few tracers have dependents, so these tables keep the largest tile
    assert tile == (32, 8)


def test_every_tile_fits_the_kernels_block():
    """The CUDA source bounds the block at 576 threads (the 32x8 tile)."""
    for tx, ty in kremap.TILES:
        n = kremap.block_threads(tx, ty)
        assert n % 32 == 0 and n <= 576
        assert n >= ty * (tx + 1) + (ty + 1) * tx     # one thread per edge
    assert kremap.block_threads(32, 8) == 576


def test_smem_layout_counts():
    # 300 ints of schedule, 6 mass + 3 x 16 reconstruction planes + 2 lists
    # on the 34 x 10 ring tile, 16 fluxes per edge thread, 4 kept + 3 mass
    # values per cell
    lay = kremap.Layout(300, 0, 0, 0, 0, 2, 16, 4)
    assert kremap.smem_bytes(32, 8, lay) == 4 * (
        300 + 56 * 340 + 16 * 576 + 7 * 256)
    # every tracer with dependents: 25 kept values per cell
    assert kremap.smem_bytes(32, 8, lay._replace(n=683, nslots=25)) == 4 * (
        683 + 56 * 340 + 16 * 576 + 28 * 256)


@pytest.mark.parametrize("name", list(TABLES))
def test_packed_schedule_round_trip(name):
    """What the kernel reads from its one int array is the schedule and
    the table."""
    import numpy as np
    table = TABLES[name]()
    NT = len(table)
    sch = kremap.build_schedule(table)
    data, (n, o_upd, o_chk, o_trc, o_lohi, nch, chunk, nslots) = \
        kremap.pack_schedule(table, sch)
    assert data.dtype == np.int32 and len(data) == n and n % 4 == 0
    assert (nch, chunk, nslots) == (len(sch.ch_nw1), sch.chunk, sch.nslots)
    assert o_upd == 4 * len(sch.ent_tr) and o_chk % 4 == 0 and o_trc % 4 == 0
    ent = data[:o_upd].reshape(-1, 4)
    assert ent[:, 0].tolist() == list(sch.ent_tr)
    assert (ent[:, 1] & 1).tolist() == list(sch.ent_own)
    assert (ent[:, 1] >> 1).tolist() == [table[t].ttype for t in sch.ent_tr]
    assert ent[:, 2].tolist() == list(sch.ent_p)
    assert ent[:, 3].tolist() == list(sch.ent_g)
    chk = data[o_chk:o_trc].reshape(nch, 8)
    owned = []
    for k in range(nch):
        e0, ne, nw1, b0, b1, b2, b3, _ = chk[k].tolist()
        assert (e0, e0 + ne, nw1) == (sch.ch_start[k], sch.ch_start[k + 1],
                                      sch.ch_nw1[k])
        for tt, (lo, hi) in zip((1, 2, 3), ((b0, b1), (b1, b2), (b2, b3))):
            for s in data[o_upd + lo:o_upd + hi].tolist():
                assert sch.ent_own[e0 + s]
                assert table[sch.ent_tr[e0 + s]].ttype == tt
                owned.append(sch.ent_tr[e0 + s])
    assert sorted(owned) == list(range(NT))           # every tracer once
    trc = data[o_trc:o_lohi].reshape(NT, 4)
    for t, f in enumerate(table):
        gp = table[f.parent].parent if f.parent >= 0 else -1
        assert trc[t].tolist() == [f.ttype, f.parent, gp, sch.vslot[t]]
    rails = data[o_lohi:o_lohi + 2 * NT].view(np.float32).reshape(NT, 2)
    ta = rx._TableArrays(table)
    assert np.array_equal(rails[:, 0], ta.lo.astype(np.float32))
    assert np.array_equal(rails[:, 1], ta.hi.astype(np.float32))


# ---------------------------------------------------------------------
# the work the kernel leaves out: donor candidates without a moment, and
# the reconstructions of cells that then donate nothing
# ---------------------------------------------------------------------

def _moving_patch(ny=20, nx=26, ew="cyclic", seed=5):
    """Three categories of ice everywhere, moving only in one patch."""
    from cice_tpu_torch.core.grid import rectgrid
    from cice_tpu_torch.core.halo import BC
    table = TABLES["default"]()
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.rand(*s, generator=gen)
    g = rectgrid(nx, ny, kmt_type="default", bc=BC(ew, "open"), device="cpu")
    ncat, NT = 3, len(table)
    aicen = 0.3 * rnd(ncat, ny, nx) * g.hm
    am = torch.cat([1.0 - aicen.sum(0, keepdim=True), aicen])
    trm = 2.0 * rnd(ncat, NT, ny, nx) + 0.5
    patch = torch.zeros(ny, nx)
    patch[6:12, 8:16] = 1.0
    u = 0.3 * g.dxU / 3600.0 * (2.0 * rnd(ny, nx) - 1.0) * patch
    v = 0.3 * g.dyU / 3600.0 * (2.0 * rnd(ny, nx) - 1.0) * patch
    dxs, dys, _ = rx.departure_points_scaled(g, u, v, 3600.0, True)
    mom_n, mom_e = rx.edge_moments(g, dxs, dys)
    return g, mom_n, mom_e, am, trm, table


def test_work_fractions_of_still_and_moving_ice():
    g, mom_n, mom_e, am, trm, table = _moving_patch()
    active, needed = kremap.work_fractions(g, mom_n, mom_e)
    assert 0.0 < active < 1.0 and 0.0 < needed < 0.5    # one small patch
    zero = torch.zeros_like(mom_n)
    assert kremap.work_fractions(g, zero, zero) == (0.0, 0.0)
    ones = torch.ones_like(mom_n)
    assert kremap.work_fractions(g, ones, ones) == (6.0, 1.0)


@pytest.mark.parametrize("ew", ["cyclic", "open"])
def test_cells_not_needed_do_not_reach_the_fluxes(ew):
    """What the kernel skips is never read: garbage in the reconstructions
    of every cell that no candidate with a moment takes from leaves the
    plain path's fluxes as they are, bit for bit."""
    from cice_tpu_torch.core.halo import shift
    g, mom_n, mom_e, am, trm, table = _moving_patch(ew=ew)
    mc, mx, my, tc, tx, ty, _ = rx.construct_fields(g, am, trm, table, g.hm)
    ref = rx.fluxes_from_moments(g, mom_n, mom_e, mc, mx, my, tc, tx, ty,
                                 table)
    need = torch.zeros(g.shape, dtype=torch.bool)
    for mom, offs in ((mom_n, rx.OFFS_N), (mom_e, rx.OFFS_E)):
        for ci, (dj, di) in enumerate(offs):
            act = (mom[ci] != 0).any(dim=0).to(mom.dtype)
            need |= shift(act, -dj, -di, bc=g.bc) > 0
    assert 0 < int(need.sum()) < need.numel() // 2
    _, needed = kremap.work_fractions(g, mom_n, mom_e)
    assert needed == float(need.sum()) / need.numel()
    junk = lambda t: torch.where(need, t, torch.full_like(t, 12345.0))
    got = rx.fluxes_from_moments(g, mom_n, mom_e, mc, mx, my, junk(tc),
                                 junk(tx), junk(ty), table)
    for a, r in zip(got[2:], ref[2:]):
        assert float(r.abs().max()) > 0 and torch.equal(a, r)


def test_bound_counts_this_runs_work():
    table = TABLES["default"]()
    nbytes, flops = kremap.bound_bytes_flops(table, 5, 384, 320)
    assert nbytes == 4 * 384 * 320 * (2 * 125 + 12 + 120 + 4)
    assert abs(flops / 1e9 - 5.69) < 0.01        # every candidate and cell
    b2, f2 = kremap.bound_bytes_flops(table, 5, 384, 320, active=0.3,
                                      needed=0.1)
    assert b2 == nbytes and f2 < 0.2 * flops
    assert kremap.bound_bytes_flops(table, 5, 384, 320, 6.0, 1.0)[1] == flops


def test_a_table_of_3000_tracers_fits_the_one_pass_kernel():
    """K2's chunked schedule keeps shared memory independent of NT up to
    thousands of tracers, which is why the port's 'auto' needs no
    'fused_pallas' fallback where the JAX package's VMEM did
    (model/step.resolve_remap_kernel)."""
    table = _wide_table(3000)
    assert len(table) == 3005
    layout = kremap.pack_schedule(table, kremap.build_schedule(table)).layout
    tile = kremap.pick_tile(layout)
    assert kremap.smem_bytes(*tile, layout) <= kremap.MAX_SMEM
    assert tile in kremap.TILES and tile[0] == 32


# ---------------------------------------------------------------------
# the flux-only kernel: tracer order with kept chain sums, its shared
# memory, and its walk replayed in PyTorch
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TABLES))
def test_flux_order_keeps_each_chain_sum_for_its_dependents(name):
    """Replay the kernel's registers: the triple of the last type-1 tracer
    with dependents and the term of the last type-2 one. Every type-2
    tracer finds its parent's triple there, every type-3 one its parent's
    term and its grandparent's triple."""
    table = TABLES[name]()
    order = kremap.flux_order(table)
    assert order.dtype == np.int32 and order.shape == (len(table), 2)
    assert sorted(order[:, 0].tolist()) == list(range(len(table)))
    assert order[:, 0].tolist() == kremap.chain_order(table)
    kept1 = kept2 = None
    for n, code in order.tolist():
        f = table[n]
        assert (code & 3, code >> 2) == (f.ttype, int(f.has_dependents))
        if f.ttype == 2:
            assert kept1 == f.parent
        elif f.ttype == 3:
            assert kept2 == f.parent and kept1 == table[f.parent].parent
        if f.has_dependents:
            if f.ttype == 1:
                kept1 = n
            else:
                kept2 = n


def test_flux_tile_fits_the_kernels_block():
    """2 threads per cell of the 32x2 tile, as csrc/tracer_fluxes.cu has
    it; shared memory of the default staging within a quarter of a block's,
    of 16 groups per chunk within a block's, and chunks that do not fit or
    hold no group refused."""
    assert kremap.FLUX_TILE == (32, 2) and kremap.FLUX_STAGES == 3
    assert kremap.flux_smem_bytes() <= kremap.MAX_SMEM // 4
    # 3 buffers of 8 groups of 3 planes, 3 ints per cell of the 34 x 4 ring
    assert kremap.flux_smem_bytes(8) == 4 * (72 + 3) * 34 * 4
    assert kremap._flux_chunk(16) == 16
    for bad in (0, 512):
        with pytest.raises(ValueError):
            kremap._flux_chunk(bad)


def _flux_walk(grid, mom_n, mom_e, mc, mx, my, tc, tx, ty, table):
    """csrc/tracer_fluxes.cu's arithmetic in PyTorch: per edge family the
    36 moment sums per category and the tracers in `flux_order` from the
    kept chain sums, each sum over the 6 candidates in CANDS order, the
    donor value by the zero-ghost shift. A candidate without a moment takes
    0 for its donor values, so its terms are +-0: the kernel leaves such a
    candidate out (its mass rows take the zeros, to load the moments
    without a branch), which adds the same nothing."""
    order = kremap.flux_order(table)
    out = []
    for mom, offs, af in ((mom_e, rx.OFFS_E, grid.earea * grid.epm),
                          (mom_n, rx.OFFS_N, grid.narea * grid.npm)):
        act = (mom != 0).any(dim=1)
        don = [lambda f, dj=dj, di=di, ci=ci: torch.where(
            act[ci], rx._shs(f, dj, di, grid.bc), 0.0)
            for ci, (dj, di) in enumerate(offs)]

        def csum(f):
            acc = torch.zeros_like(f[0])
            for ci in range(6):
                acc = acc + f[ci]
            return acc

        m = [[mom[ci, q] for q in range(10)] for ci in range(6)]
        ms0 = [don[ci](mc[0]) * m[ci][0] + don[ci](mx[0]) * m[ci][1]
               + don[ci](my[0]) * m[ci][2] for ci in range(6)]
        mflx, mtflx = [(-csum(ms0)) * af], []
        for c in range(tc.shape[0]):
            mi, mxi, myi = ([don[ci](f[c + 1]) for ci in range(6)]
                            for f in (mc, mx, my))
            C = [[mi[ci] * m[ci][a] + mxi[ci] * m[ci][b] + myi[ci] * m[ci][d]
                  for a, b, d in ((0, 1, 2), (1, 3, 4), (2, 4, 5),
                                  (3, 6, 7), (4, 7, 8), (5, 8, 9))]
                 for ci in range(6)]
            mflx.append((-csum([C[ci][0] for ci in range(6)])) * af)
            row = [None] * len(table)
            for n, code in order.tolist():
                tt, dep = code & 3, code >> 2
                t0, t1, t2 = ([don[ci](f[c, n]) for ci in range(6)]
                              for f in (tc, tx, ty))
                if tt == 1:
                    mts = [C[ci][0] * t0[ci] + C[ci][1] * t1[ci]
                           + C[ci][2] * t2[ci] for ci in range(6)]
                    if dep:
                        p1 = mts
                        p2 = [C[ci][1] * t0[ci] + C[ci][3] * t1[ci]
                              + C[ci][4] * t2[ci] for ci in range(6)]
                        p3 = [C[ci][2] * t0[ci] + C[ci][4] * t1[ci]
                              + C[ci][5] * t2[ci] for ci in range(6)]
                elif tt == 2:
                    mts = [p1[ci] * t0[ci] + p2[ci] * t1[ci]
                           + p3[ci] * t2[ci] for ci in range(6)]
                    if dep:
                        q = mts
                else:
                    mts = [q[ci] * t0[ci] for ci in range(6)]
                row[n] = (-csum(mts)) * af
            mtflx.append(torch.stack(row))
        out += [torch.stack(mflx), torch.stack(mtflx)]
    mflxe, mtflxe, mflxn, mtflxn = out
    return mflxe, mflxn, mtflxe, mtflxn


@pytest.mark.parametrize("ew", ["cyclic", "open"])
@pytest.mark.parametrize("name", ["default", "nlay30"])
def test_flux_kernel_walk_equals_plain_bit_for_bit(name, ew):
    """The flux kernel's order of operations (candidates without a moment
    left out, chain sums kept, each tracer's candidates in CANDS order)
    gives the plain version's fluxes bit for bit, in f32, on ice moving in
    one patch and with every candidate of a small grid moving."""
    g, mom_n, mom_e, am, trm, _ = _moving_patch(ew=ew)
    table = TABLES[name]()
    if len(table) != trm.shape[1]:
        gen = torch.Generator().manual_seed(9)
        trm = 2.0 * torch.rand(am.shape[0] - 1, len(table), *g.shape,
                               generator=gen) + 0.5
    mc, mx, my, tc, tx, ty, _ = rx.construct_fields(g, am, trm, table, g.hm)
    for mn, me in ((mom_n, mom_e), (mom_n + 1e-3, mom_e - 1e-3)):
        args = (g, mn, me, mc, mx, my, tc, tx, ty, table)
        ref = kremap.tracer_fluxes_plain(*args)
        got = _flux_walk(*args)
        for a, r in zip(got, ref):
            assert float(r.abs().max()) > 0
            assert a.shape == r.shape and torch.equal(a, r)


def test_tracer_fluxes_bound_counts_this_runs_work():
    """The reconstruction planes (tracer and mass; a type-3 tracer's tc
    alone) count for the needed cells only, the operations for the
    candidates that count: at the gx1 shapes, the gx1pop state's fractions
    give ~218 MB and the dense case's ~318 MB, against 372.1 MB with every
    candidate."""
    table = TABLES["default"]()
    P = 384 * 320
    full_b, full_f = kremap.tracer_fluxes_bound_bytes_flops(table, 5, 384,
                                                            320)
    assert (full_b, full_f) == kremap.tracer_fluxes_bound_bytes_flops(
        table, 5, 384, 320, 6.0, 1.0)
    b, f = kremap.tracer_fluxes_bound_bytes_flops(table, 5, 384, 320,
                                                  active=0.315, needed=0.162)
    # 5 x (23 x 3 + 2 x 1) tracer and 6 x 3 mass reconstruction planes
    assert b == 4 * P * (0.162 * (355 + 18) + 120 + 2 + 262)
    assert abs(b / 1e6 - 218.44) < 0.01 and abs(full_b / 1e6 - 372.08) < 0.01
    bd, fd = kremap.tracer_fluxes_bound_bytes_flops(table, 5, 384, 320,
                                                    1.74, 0.706)
    assert abs(bd / 1e6 - 318.18) < 0.01
    # the operations follow the candidates that count; the scaling of
    # each flux by its edge area stays
    assert f == 2 * P * kremap._edge_flops(table, 5, 0.315,
                                           kremap._memo_flops)
    assert f < 0.1 * full_f and f < fd < full_f
    # kept chain sums: fewer operations than the every-candidate count of
    # the one-pass kernel's chains (K2 recomputes them per child)
    assert full_f < 2 * P * kremap._edge_flops(table, 5)
    z_b, z_f = kremap.tracer_fluxes_bound_bytes_flops(table, 5, 384, 320,
                                                      0.0, 0.0)
    assert z_f == 2 * P * 5 * 25 * 2 and z_b == 4 * P * (120 + 2 + 262)


def test_grid_planes_are_built_once_per_grid():
    """The kernels' edge-area and T planes come from a cache: the same
    tensors for the same grid, new ones for another grid."""
    g = _moving_patch()[0]
    afn, afe, tarear, hm = kremap._grid_planes(g)
    assert torch.equal(afn, (g.narea * g.npm).float())
    assert torch.equal(afe, (g.earea * g.epm).float())
    assert afn.is_contiguous() and hm.dtype == torch.float32
    again = kremap._grid_planes(g)
    assert all(a is b for a, b in zip(again, (afn, afe, tarear, hm)))
    g2 = _moving_patch(ny=12, nx=10)[0]
    assert kremap._grid_planes(g2)[0].shape == (12, 10)
    assert kremap._grid_planes(g)[0] is afn


def test_dense_case_moves_ice_everywhere():
    """The dense recipe of the measurements, at a small size on the CPU:
    far more candidates and cells than the patch, every cell of the
    flux case finite."""
    from cice_tpu_torch.measure import dense_transport_case, flux_case
    g, *_ = _moving_patch()
    table = TABLES["default"]()
    case = dense_transport_case(g, table, 3, "cpu")
    active, needed = kremap.work_fractions(*case[:3])
    p_active, p_needed = kremap.work_fractions(*_moving_patch()[:3])
    assert active > 1.0 and needed > 0.6
    assert active > 5 * p_active and needed > 2 * p_needed
    (fg, *fargs), tstack = flux_case(*case)
    assert fg is g and tstack.shape == (3, 75) + g.shape
    assert all(bool(torch.isfinite(t).all()) for t in fargs[:8])
