"""The chunk schedule and the tile choice of the one-pass transport kernel
(cice_tpu_torch/kernels/remap.py `build_schedule`, `pick_tile`,
`smem_bytes`; consumed by csrc/transport_fused.cu), checked on the CPU.

The kernel walks the schedule as it stands: per chunk it reconstructs the
entries (types 1 and 3 first, then type 2 from their parents' slots),
fluxes the owned ones, and updates them one chain type after the other
(1, 2, 3), reading each parent's unclipped new value from the slot `vslot`
gives it. `_walk` replays exactly that order and fails
where the kernel would read something not yet written.
"""

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
