"""The tile decomposition of the persistent fused-EVP kernel
(cice_tpu_torch/csrc/evp_fused.cu), checked on the CPU where no card is at
hand.

(a) `kernels.evp.choose_route`: which grids run `persistent`, with what
    tile, and which fall to `stream`.
(b) A plain PyTorch emulation of the persistent design, written here: each
    tile's block owns its cells, also relaxes the stresses of the one T row
    north and the one T column east of them, and gets from its neighbours
    only a one-cell ring of u, v, once per subcycle, through a buffer that
    holds nothing but tile perimeters (NaN elsewhere) and alternates by
    subcycle parity; the force diagnostics are folded into the tail. It
    must equal `evp_solve` bit for bit in f32 (the blocks repeat their
    neighbours' arithmetic on the same inputs, and elementwise IEEE
    arithmetic does not depend on where in a tensor a cell lies), which
    proves the halo width and the ownership rule.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch import constants as cst  # noqa: E402
from cice_tpu_torch.core.grid import rectgrid  # noqa: E402
from cice_tpu_torch.core.halo import BC  # noqa: E402
from cice_tpu_torch.dynamics.common import (DYNPREP_FIELDS, DynPrep,  # noqa: E402
                                            dyn_prep, evp_params,
                                            stepu_dense)
from cice_tpu_torch.dynamics.evp import evp_solve, stress_update  # noqa: E402
from cice_tpu_torch.kernels import evp as kevp  # noqa: E402

H100 = dict(sm_count=132, smem_per_block=232448, blocks_per_sm=1)


def _blocks(ny, nx, tile):
    return -(-ny // tile[0]) * -(-nx // tile[1])


@pytest.mark.parametrize("name,ny,nx", [
    ("gx1", 384, 320), ("gx3", 116, 100), ("tx1", 240, 360),
    ("test grid", 40, 48), ("ragged", 29, 37)])
def test_choose_route_persistent(name, ny, nx):
    route, tile = kevp.choose_route(ny, nx, **H100)
    assert route == "persistent", name
    th, tw = tile
    assert _blocks(ny, nx, tile) <= H100["sm_count"]
    assert kevp.persistent_smem_bytes(th, tw) <= H100["smem_per_block"]
    assert 1 <= th <= ny and 1 <= tw <= nx


def test_choose_route_gx1_tile():
    """gx1 cuts into 13 x 10 tiles of 30 x 32: 31 x 33 = 1023 T cells, one
    for each of the block's 1024 threads, on 130 of the 132 SMs."""
    route, tile = kevp.choose_route(384, 320, **H100)
    assert (route, tile) == ("persistent", (30, 32))
    assert _blocks(384, 320, tile) == 130
    assert (tile[0] + 1) * (tile[1] + 1) <= kevp.PERSIST_THREADS == 1024


@pytest.mark.parametrize("ny,nx,card", [
    (1200, 1440, H100),                               # too many tiles
    (384, 320, dict(H100, sm_count=64)),              # half a card
    (384, 320, dict(H100, sm_count=114)),             # gx1 on an H100 PCIe
    (384, 320, dict(H100, sm_count=129)),             # one SM short of 130
    (384, 320, dict(H100, smem_per_block=49152)),     # no opt-in smem
    (48, 40, dict(H100, blocks_per_sm=0))])           # kernel not resident
def test_choose_route_stream(ny, nx, card):
    assert kevp.choose_route(ny, nx, **card) == ("stream", None)


def test_choose_route_uses_more_blocks_per_sm():
    route, tile = kevp.choose_route(384, 320, **dict(H100, sm_count=66,
                                                     blocks_per_sm=2))
    assert (route, tile) == ("persistent", (30, 32))


# ---------------------------------------------------------------------
# (b) the emulation
# ---------------------------------------------------------------------

def _window(t, j0, i0, h, w, xcyc):
    """Rows j0..j0+h-1 and columns i0..i0+w-1 of t (..., ny, nx): wrapped
    in x when cyclic, zero (False) outside the domain otherwise."""
    ny, nx = t.shape[-2:]
    jj, ii = torch.arange(j0, j0 + h), torch.arange(i0, i0 + w)
    okx = torch.ones(w, dtype=torch.bool) if xcyc else (ii >= 0) & (ii < nx)
    ii = ii % nx if xcyc else ii.clamp(0, nx - 1)
    oky = (jj >= 0) & (jj < ny)
    out = t[..., jj.clamp(0, ny - 1)[:, None], ii[None, :]]
    return torch.where(oky[:, None] & okx[None, :], out,
                       torch.zeros((), dtype=t.dtype))


class _Tile:
    """One block: its frame is its tile plus a one-cell ring."""

    def __init__(self, grid, prep, fields, stresses, j0, i0, th, tw):
        self.j0, self.i0, self.th, self.tw = j0, i0, th, tw
        xcyc = grid.bc.x_cyclic
        self.win = lambda t: _window(t, j0 - 1, i0 - 1, th + 2, tw + 2, xcyc)
        tensors = {f.name: self.win(getattr(grid, f.name))
                   for f in dataclasses.fields(grid)
                   if isinstance(getattr(grid, f.name), torch.Tensor)}
        self.grid = dataclasses.replace(
            grid, **tensors, bc=BC("open", "open"), ny_global=th + 2,
            nx_global=tw + 2)
        self.prep = DynPrep(**{k: self.win(getattr(prep, k))
                               for k in DYNPREP_FIELDS})
        self.f = {k: self.win(v) for k, v in fields.items()}
        m = self.prep.iceTmask[None]
        self.s = [torch.where(m, self.win(s), 0.0) for s in stresses]
        self.u, self.v = self.prep.uvel, self.prep.vvel
        self.own = (slice(1, th + 1), slice(1, tw + 1))
        self.glob = (slice(j0, j0 + th), slice(i0, i0 + tw))
        per = torch.zeros((th, tw), dtype=torch.bool)
        per[0] = per[-1] = per[:, 0] = per[:, -1] = True
        self.perimeter = per

    def stress(self, p):
        return stress_update(self.grid, p, self.f["strength"],
                             self.f["DminTarea"], self.u, self.v, *self.s,
                             self.prep.iceTmask)

    def subcycle(self, p, halo):
        *self.s, strx, stry = self.stress(p)
        u, v, _, _ = stepu_dense(self.u, self.v, strx, stry, self.prep, p,
                                 self.f["uocn"], self.f["vocn"])
        self.u_own, self.v_own = u[self.own], v[self.own]
        nan = torch.full_like(self.u_own, float("nan"))
        halo[0][self.glob] = torch.where(self.perimeter, self.u_own, nan)
        halo[1][self.glob] = torch.where(self.perimeter, self.v_own, nan)

    def read_ring(self, halo):
        self.u, self.v = self.win(halo[0]), self.win(halo[1])
        self.u[self.own], self.v[self.own] = self.u_own, self.v_own

    def tail(self, p, out):
        *_, strx, stry = self.stress(p)
        u, v = self.u[self.own], self.v[self.own]
        Cb = self.prep.TbU[self.own] / (torch.sqrt(u ** 2 + v ** 2) + cst.u0)
        planes = [u, v, *(s[(slice(None),) + self.own] for s in self.s),
                  strx[self.own], stry[self.own], -u * Cb, -v * Cb]
        for o, t in zip(out, planes):
            o[(Ellipsis,) + self.glob] = t


def _emulate(grid, p, prep, strength, stressp, stressm, stress12, tile, *,
             uocn, vocn):
    ny, nx = grid.shape
    TH, TW = tile
    fields = dict(strength=strength, DminTarea=p.deltaminEVP * grid.tarea,
                  uocn=uocn, vocn=vocn)
    tiles = [_Tile(grid, prep, fields, (stressp, stressm, stress12), j0, i0,
                   min(TH, ny - j0), min(TW, nx - i0))
             for j0 in range(0, ny, TH) for i0 in range(0, nx, TW)]
    halo = torch.full((2, 2, ny, nx), float("nan"))
    for it in range(p.ndte):
        for t in tiles:
            t.subcycle(p, halo[it & 1])
        for t in tiles:                  # after the barrier
            t.read_ring(halo[it & 1])
        halo[it & 1].fill_(float("nan"))
    z = lambda *s: torch.full(s + (ny, nx), float("nan"))
    out = (z(), z(), z(4), z(4), z(4), z(), z(), z(), z())
    for t in tiles:
        t.tail(p, out)
    return out


def _problem(ny, nx, ew, ndte, seed=0):
    cfg = tconfig.Config().with_overrides(**{
        "grid.nx_global": nx, "grid.ny_global": ny,
        "grid.ew_boundary_type": ew, "dynamics.ndte": ndte,
        "dynamics.coriolis": "latitude", "dynamics.seabed_stress": True,
        "dynamics.threshold_hw": 5e3})
    grid = rectgrid(nx, ny, kmt_type="default", bc=BC(ew, "open"),
                    device="cpu")
    rng = np.random.default_rng(seed)
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    jj, ii = np.mgrid[0:ny, 0:nx]
    tm = grid.hm.numpy()
    aice = (0.9 - 0.3 * np.exp(-((ii - nx / 2) / 6.0) ** 2)) * tm
    aice[: ny // 5] = 0.0                          # an ice-free band
    vice = aice * (1.0 + 0.4 * rng.random((ny, nx)))
    prep = dyn_prep(
        grid, cfg.dynamics, 3600.0, aice=T(aice), vice=T(vice),
        vsno=T(aice * 0.1 * rng.random((ny, nx))),
        aiceU_prev_mask=torch.as_tensor(rng.random((ny, nx)) > 0.3),
        uvel=T(0.05 * rng.standard_normal((ny, nx))),
        vvel=T(0.05 * rng.standard_normal((ny, nx))),
        strairxT=T(0.12 * np.sin(2 * np.pi * jj / ny) + 0.06),
        strairyT=T(0.08 * np.cos(2 * np.pi * ii / nx)),
        uocn_T=T(0.1 * np.cos(2 * np.pi * jj / ny)),
        vocn_T=T(0.05 * np.sin(2 * np.pi * ii / nx)),
        ss_tltx_T=T(0 * aice), ss_tlty_T=T(0 * aice))
    p = evp_params(cfg.dynamics, 3600.0)
    strength = T(2.75e4 * vice * np.exp(-20.0 * (1.0 - aice)))
    sp, sm, s12 = (T(1e3 * rng.standard_normal((4, ny, nx)))
                   for _ in range(3))
    kw = dict(uocn=T(0.1 * np.cos(2 * np.pi * jj / ny)),
              vocn=T(0.05 * np.sin(2 * np.pi * ii / nx)))
    return (grid, p, prep, strength, sp, sm, s12), kw


NAMES = ("uvel", "vvel", "stressp", "stressm", "stress12", "strintx",
         "strinty", "taubx", "tauby")


@pytest.mark.parametrize("ny,nx,ew,ndte,tile", [
    (29, 37, "cyclic", 5, (8, 10)),     # ragged: a 5-row and a 7-column rim
    (29, 37, "open", 4, (7, 9)),        # a tile row of one cell
    (24, 32, "cyclic", 3, (8, 32)),     # one tile column, wrapped on itself
    (24, 32, "open", 1, (8, 8)),        # ndte = 1
    (12, 10, "cyclic", 3, (2, 1)),      # tiles that are all perimeter
    (20, 26, "cyclic", 2, None)])       # the chooser's tile on a tiny card
def test_persistent_emulation_matches_evp_solve_bitwise(ny, nx, ew, ndte,
                                                        tile):
    args, kw = _problem(ny, nx, ew, ndte)
    if tile is None:
        route, tile = kevp.choose_route(ny, nx, sm_count=6,
                                        smem_per_block=232448,
                                        blocks_per_sm=1)
        assert route == "persistent" and _blocks(ny, nx, tile) > 1
    ref = evp_solve(*args, **kw)
    got = _emulate(*args, tile, **kw)
    speed = float(torch.sqrt(ref[0] ** 2 + ref[1] ** 2).max())
    assert speed > 1e-3 and bool(args[2].iceTmask.any())
    for name, g, r in zip(NAMES, got, ref):
        assert g.dtype == torch.float32
        assert torch.equal(g, r), (name, float((g - r).abs().max()))


def test_emulation_detects_a_missing_ring():
    """The check has teeth: without the ring exchange (every block keeps
    its initial ring) the answer differs."""
    args, kw = _problem(24, 32, "cyclic", 3)
    ref = evp_solve(*args, **kw)
    keep = _Tile.read_ring

    def no_ring(self, halo):
        self.u, self.v = self.u.clone(), self.v.clone()
        self.u[self.own], self.v[self.own] = self.u_own, self.v_own
    _Tile.read_ring = no_ring
    try:
        got = _emulate(*args, (8, 8), **kw)
    finally:
        _Tile.read_ring = keep
    assert not torch.equal(got[0], ref[0])


def test_persistent_smem_fits_the_chosen_tiles():
    for ny, nx in ((384, 320), (116, 100), (240, 360), (40, 48), (29, 37)):
        _, (th, tw) = kevp.choose_route(ny, nx, **H100)
        assert kevp.persistent_smem_bytes(th, tw) <= H100["smem_per_block"]
    # per thread 12 stresses, 10 + 14 constants, 8 divergence terms; u and
    # v on the ring tile
    assert kevp.persistent_smem_bytes(30, 32) == 4 * (44 * 1024 +
                                                      2 * 32 * 34)


def test_choose_route_gives_every_t_cell_a_thread():
    """A tile has at most as many T cells as its block has threads, and
    small grids spread over many SMs rather than fill a few blocks."""
    for ny, nx in ((384, 320), (116, 100), (240, 360), (40, 48), (29, 37)):
        _, (th, tw) = kevp.choose_route(ny, nx, **H100)
        assert (th + 1) * (tw + 1) <= kevp.PERSIST_THREADS
    _, tile = kevp.choose_route(116, 100, **H100)
    assert _blocks(116, 100, tile) > 100
    # a grid whose even splits into 132 tiles all exceed the block
    assert kevp.choose_route(400, 400, **H100) == ("stream", None)
