"""PyTorch port vs JAX package: the wide-halo EVP across ranks
(cice_tpu_torch.parallel.evp_wide, .mesh) against tests/test_evp_wide.py
and tests/test_evp_c_wide.py.

Every case of those files runs here on gloo ranks (8 spawned processes,
cice_tpu_torch.parallel.spawn; the C-grid cases of the JAX tests on 4 of
them, as those use a 2x2 mesh, and one more on all 8) with the JAX tests'
inputs. The port's wide solve
must equal the port's own one-program solve (`evp_solve`, `evp_c_solve`)
exactly, on every rank: the tiles do the same operations on the same
values, the tripole fold included. The JAX tests hold JAX's wide solve to
1e-5 of its one-program solve, because XLA compiles the two differently;
the port is held to JAX's wide solve within that tolerance. Mesh shapes
(2,4), (4,2) and (1,8) give the same bits, with and without the fold,
and the C grid gives the same bits with k=1 and k=4. A 1x1 mesh without a
process group runs the tiled path in this process (its cyclic halos are
messages to itself). Two Model steps with evp_algorithm='wide_halo' on a
2x4 mesh equal two steps of the one-program solve bit for bit, on the B
and the C grid.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cice_tpu.columns.ridging import ice_strength as jice_strength  # noqa: E402
from cice_tpu.config import Config as JConfig  # noqa: E402
from cice_tpu.core.grid import rectgrid as jrectgrid  # noqa: E402
from cice_tpu.core.halo import BC as JBC  # noqa: E402
from cice_tpu.dynamics.common import dyn_prep as jdyn_prep  # noqa: E402
from cice_tpu.dynamics.common import evp_params as jevp_params  # noqa: E402
from cice_tpu.dynamics.common import ice_strength_hibler as jhibler  # noqa: E402
from cice_tpu.dynamics.evp_c import dyn_prep_c as jdyn_prep_c  # noqa: E402
from cice_tpu.parallel.evp_wide import evp_c_solve_wide as jwide_c  # noqa: E402
from cice_tpu.parallel.evp_wide import evp_solve_wide as jwide  # noqa: E402
from cice_tpu.parallel.mesh import make_mesh  # noqa: E402
from cice_tpu_torch import convert  # noqa: E402
from cice_tpu_torch.config import Config  # noqa: E402
from cice_tpu_torch.core.halo import BC  # noqa: E402
from cice_tpu_torch.dynamics.common import DYNPREP_FIELDS, EvpParams  # noqa: E402
from cice_tpu_torch.dynamics.evp import evp_solve  # noqa: E402
from cice_tpu_torch.dynamics.evp_c import CPrep, evp_c_solve  # noqa: E402
from cice_tpu_torch.model.driver import Model  # noqa: E402
from cice_tpu_torch.model.state import state_leaves  # noqa: E402
from cice_tpu_torch.parallel import spawn  # noqa: E402
from cice_tpu_torch.parallel.evp_wide import (evp_c_solve_wide,  # noqa: E402
                                              evp_solve_wide)
from cice_tpu_torch.parallel.mesh import Mesh  # noqa: E402

import test_torch_rank_jobs as rank_jobs  # noqa: E402

B_OUT = ("uvel", "vvel", "stressp", "stressm", "stress12", "strintx",
         "strinty", "taubx", "tauby")
C_OUT = ("uvelE", "vvelN", "stresspT", "stressmT", "stress12U", "uvelU",
         "vvelU")

# B grid, 48x32: (ew, ns), ndte, k_fuse, mesh; the first six are the cases
# of tests/test_evp_wide.py, held against JAX's wide solve as well
B_CASES = {
    "cyclic_x_open_ns_with_remainder": (("cyclic", "open"), 11, 4, (2, 4)),
    "open_x_closed_ns_single_chunk": (("open", "closed"), 8, 8, (2, 4)),
    "doubly_cyclic": (("cyclic", "cyclic"), 6, 2, (2, 4)),
    "k_clamped_to_tile": (("cyclic", "open"), 12, 64, (2, 4)),
    "tripole": (("cyclic", "tripole"), 7, 3, (2, 4)),
    "tripoleT": (("cyclic", "tripoleT"), 7, 3, (2, 4)),
    "mesh_2x4": (("cyclic", "open"), 9, 4, (2, 4)),
    "mesh_4x2": (("cyclic", "open"), 9, 4, (4, 2)),
    "mesh_1x8": (("cyclic", "open"), 9, 4, (1, 8)),
    "fold_2x4": (("cyclic", "tripole"), 6, 3, (2, 4)),
    "fold_1x8": (("cyclic", "tripole"), 6, 3, (1, 8)),
    "fold_4x2": (("cyclic", "tripole"), 6, 3, (4, 2)),
}
B_JAX = list(B_CASES)[:6]
# C grid, 64x64 on 2x2 (tests/test_evp_c_wide.py), and once on all 8
# ranks (tiles 32x16: k clamped to 2)
C_CASES = {
    "c_cyclic_remainder": (("cyclic", "open"), 7, 3, (2, 2)),
    "c_open_closed": (("open", "closed"), 4, 4, (2, 2)),
    "c_k1": (("cyclic", "open"), 8, 1, (2, 2)),
    "c_k4": (("cyclic", "open"), 8, 4, (2, 2)),
    "c_2x4": (("cyclic", "open"), 7, 3, (2, 4)),
}
C_JAX = ["c_cyclic_remainder", "c_open_closed"]

MODEL_BASE = {
    "grid.nx_global": 32, "grid.ny_global": 32,
    "grid.grid_format": "rect", "grid.kmt_type": "none",
    "forcing.atm_data_type": "box2001", "forcing.ocn_data_type": "box2001",
    "dynamics.ndte": 10, "thermo.nit": 4,
}
WIDE = {"dynamics.evp_algorithm": "wide_halo", "dynamics.evp_wide_k": 4}


def _np(obj, names):
    return {k: np.asarray(getattr(obj, k)) for k in names}


def _jax_b_problem(nx, ny, bc, ndte, seed=0):
    """tests/test_evp_wide.py::_problem."""
    cfg = JConfig().with_overrides(**{
        "grid.nx_global": nx, "grid.ny_global": ny, "dynamics.ndte": ndte,
        "dynamics.coriolis": "latitude"})
    grid = jrectgrid(nx, ny, kmt_type="none", bc=JBC(*bc), dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: jnp.asarray(rng.uniform(lo, hi, (ny, nx)), jnp.float32)
    aice = jnp.clip(f(0.0, 1.2), 0.0, 1.0)
    vice = aice * f(0.5, 3.0)
    z = jnp.zeros((ny, nx), jnp.float32)
    prep = jdyn_prep(grid, cfg.dynamics, cfg.setup.dt, aice=aice, vice=vice,
                     vsno=0.1 * vice,
                     aiceU_prev_mask=jnp.zeros((ny, nx), bool),
                     uvel=f(-0.1, 0.1), vvel=f(-0.1, 0.1),
                     strairxT=f(-0.2, 0.2), strairyT=f(-0.2, 0.2),
                     uocn_T=f(-0.05, 0.05), vocn_T=f(-0.05, 0.05),
                     ss_tltx_T=z, ss_tlty_T=z)
    p = jevp_params(cfg.dynamics, cfg.setup.dt)
    strength = jice_strength(jnp.stack([aice / 5] * 5),
                             jnp.stack([vice / 5] * 5), aice, vice,
                             cfg.dynamics)
    sp = jnp.asarray(rng.uniform(-100, 100, (4, ny, nx)), jnp.float32)
    sm = jnp.asarray(rng.uniform(-100, 100, (4, ny, nx)), jnp.float32)
    s12 = jnp.asarray(rng.uniform(-50, 50, (4, ny, nx)), jnp.float32)
    return grid, p, prep, strength, sp, sm, s12, f(-0.1, 0.1), f(-0.1, 0.1)


def _jax_c_problem(nx, ny, bc, ndte, seed=0):
    """tests/test_evp_c_wide.py::_problem."""
    cfg = JConfig().with_overrides(**{
        "grid.nx_global": nx, "grid.ny_global": ny,
        "dynamics.ndte": ndte, "dynamics.coriolis": "latitude"})
    grid = jrectgrid(nx, ny, kmt_type="none", bc=JBC(*bc), dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: jnp.asarray(rng.uniform(lo, hi, (ny, nx)), jnp.float32)
    aice = jnp.clip(f(0.0, 1.2), 0.0, 1.0)
    vice = aice * f(0.5, 3.0)
    prep = jdyn_prep_c(grid, cfg.dynamics, cfg.setup.dt, aice=aice,
                       vice=vice, vsno=0.1 * vice, uvelE=f(-0.1, 0.1),
                       vvelN=f(-0.1, 0.1), strairxT=f(-0.2, 0.2),
                       strairyT=f(-0.2, 0.2), uocn_T=f(-0.05, 0.05),
                       vocn_T=f(-0.05, 0.05))
    p = jevp_params(cfg.dynamics, cfg.setup.dt)
    strength = jhibler(aice, vice)
    spT = jnp.asarray(rng.uniform(-100, 100, (ny, nx)), jnp.float32)
    smT = jnp.asarray(rng.uniform(-100, 100, (ny, nx)), jnp.float32)
    s12U = jnp.asarray(rng.uniform(-50, 50, (ny, nx)), jnp.float32)
    return grid, p, prep, strength, spT, smT, s12U


def _port_grid(jg, bc):
    names = [f.name for f in dataclasses.fields(jg)
             if f.name not in ("bc", "nx_global", "ny_global")]
    return convert.grid_from_numpy(_np(jg, names), BC(*bc), "cpu")


def _port_p(jp):
    return EvpParams(**{k: getattr(jp, k) for k in EvpParams._fields})


def _t(x):
    return torch.as_tensor(np.array(x))


def _port_b(jprob, bc):
    jg, jp, jprep, strength, sp, sm, s12, uocn, vocn = jprob
    prep = convert.dynprep_from_numpy(_np(jprep, DYNPREP_FIELDS), "cpu")
    return ((_port_grid(jg, bc), _port_p(jp), prep, _t(strength), _t(sp),
             _t(sm), _t(s12)), dict(uocn=_t(uocn), vocn=_t(vocn)))


def _port_c(jprob, bc):
    jg, jp, jprep, strength, spT, smT, s12U = jprob
    return (_port_grid(jg, bc), _port_p(jp), CPrep(*(_t(x) for x in jprep)),
            _t(strength), _t(spT), _t(smT), _t(s12U))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on spawned gloo ranks, in one launch: {case: (the rank
    results, the port's one-program outputs, the JAX problem)}."""
    wd = str(tmp_path_factory.mktemp("evp_wide"))
    jobs, cases = [], []
    for name, (bc, ndte, k, shape) in B_CASES.items():
        jprob = _jax_b_problem(48, 32, bc, ndte)
        args, kw = _port_b(jprob, bc)
        ref = evp_solve(*args, **kw)
        path = spawn.save(spawn.b_problem_to_numpy(*args, **kw),
                          f"{wd}/{name}.pkl")
        jobs.append(("evp_b", dict(problem=path, shape=shape, k_fuse=k), 8))
        cases.append((name, ref, jprob))
    for name, (bc, ndte, k, shape) in C_CASES.items():
        jprob = _jax_c_problem(64, 64, bc, ndte)
        args = _port_c(jprob, bc)
        fin, uU, vU = evp_c_solve(*args)
        path = spawn.save(spawn.c_problem_to_numpy(*args), f"{wd}/{name}.pkl")
        jobs.append(("evp_c", dict(problem=path, shape=shape, k_fuse=k),
                     shape[0] * shape[1]))
        cases.append((name, list(fin) + [uU, vU], jprob))
    for grid_ice in ("B", "C"):
        cfg = Config().with_overrides(**MODEL_BASE, **WIDE,
                                      **{"grid.grid_ice": grid_ice})
        jobs.append(("model_steps", dict(cfg=cfg, nsteps=2, shape=(2, 4)),
                     8))
    layouts = [dict(shape=(2, 4)), dict(shape=(2, 4), curve_order=True),
               dict(grid_shape=(384, 320)), dict()]
    jobs += [(rank_jobs.mesh_layout, kw, 8) for kw in layouts]
    res = spawn.launch(jobs, 8, wd, timeout=300.0)
    out = {name: (r, ref, jprob)
           for (name, ref, jprob), r in zip(cases, res)}
    n = len(cases)
    out["model_B"], out["model_C"] = res[n], res[n + 1]
    out["layouts"] = list(zip(layouts, res[n + 2:]))
    return out


def _ranks_agree(r):
    got = [x for x in r if x is not None]
    assert len({x["digest"] for x in got}) == 1, "the ranks' results differ"
    return got[0]["out"]


def _exact(names, got, ref):
    for name, a, b in zip(names, got, ref):
        b = b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", list(B_CASES))
def test_b_wide_equals_the_one_program_solve(runs, case):
    r, ref, _ = runs[case]
    _exact(B_OUT, _ranks_agree(r), ref)


@pytest.mark.parametrize("case", B_JAX)
def test_b_wide_matches_jax_wide(runs, case, devices8):
    """tests/test_evp_wide.py's tolerance (its two programs differ by f32
    rounding): rtol 1e-5, atol 1e-5 of max(1, |ref|)."""
    r, _, jprob = runs[case]
    bc, ndte, k, shape = B_CASES[case]
    jg, jp, jprep, strength, sp, sm, s12, uocn, vocn = jprob
    mesh = make_mesh(shape, devices=jax.devices()[:8])
    want = jax.jit(lambda: jwide(jg, jp, jprep, strength, sp, sm, s12,
                                 uocn=uocn, vocn=vocn, mesh=mesh,
                                 k_fuse=k))()
    for name, a, b in zip(B_OUT, want, _ranks_agree(r)):
        a = np.asarray(a)
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("family", ["mesh", "fold"])
def test_mesh_shape_invariance(runs, family):
    """(2,4), (4,2) and (1,8) give the same bits (the JAX tests allow 1e-6
    between mesh shapes)."""
    outs = [_ranks_agree(runs[f"{family}_{s}"][0])
            for s in ("2x4", "4x2", "1x8")]
    for other in outs[1:]:
        for name, a, b in zip(B_OUT, outs[0], other):
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", list(C_CASES))
def test_c_wide_equals_the_one_program_solve(runs, case):
    r, ref, _ = runs[case]
    _exact(C_OUT, _ranks_agree(r), ref)


@pytest.mark.parametrize("case", C_JAX)
def test_c_wide_matches_jax_wide(runs, case, devices8):
    """tests/test_evp_c_wide.py's tolerance: rtol 1e-5, atol 1e-5 of
    max(1, |ref|) (uvelU, vvelU: atol 1e-5)."""
    r, _, jprob = runs[case]
    bc, ndte, k, shape = C_CASES[case]
    jg, jp, jprep, strength, spT, smT, s12U = jprob
    mesh = make_mesh(shape, devices=jax.devices()[:4])
    fin, uU, vU = jax.jit(lambda: jwide_c(jg, jp, jprep, strength, spT, smT,
                                          s12U, mesh=mesh, k_fuse=k))()
    for name, a, b in zip(C_OUT, list(fin) + [uU, vU], _ranks_agree(r)):
        a = np.asarray(a)
        scale = 1.0 if name in ("uvelU", "vvelU") else \
            max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)


def test_c_wide_k1_vs_k4(runs):
    """k=1 (an exchange every subcycle) and k=4 (the deep cone) give the
    same bits: C_RADIUS rings per subcycle are enough."""
    for name, a, b in zip(C_OUT, _ranks_agree(runs["c_k1"][0]),
                          _ranks_agree(runs["c_k4"][0])):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("bc", [("cyclic", "open"), ("cyclic", "cyclic"),
                                ("cyclic", "tripole")])
def test_one_rank_mesh_and_no_mesh(bc):
    """mesh=None is the one-program solve (the JAX package's fallback;
    `evp_solve` on CPU tensors); a 1x1 Mesh with no process group runs the
    tiled path here, its cyclic halos and the fold as messages to itself,
    and gives the same bits."""
    args, kw = _port_b(_jax_b_problem(24, 16, bc, 5), bc)
    ref = evp_solve(*args, **kw)
    _exact(B_OUT, [x.numpy() for x in evp_solve_wide(*args, **kw,
                                                     mesh=None)], ref)
    mesh = Mesh()
    assert mesh.shape == (1, 1) and mesh.backend is None
    got = evp_solve_wide(*args, **kw, mesh=mesh, k_fuse=2)
    _exact(B_OUT, [x.numpy() for x in got], ref)
    assert mesh.exchanges > 0 and mesh.staged_bytes == 0
    cargs = _port_c(_jax_c_problem(24, 16, bc, 4), bc)
    fin, uU, vU = evp_c_solve(*cargs)
    got = evp_c_solve_wide(*cargs, mesh=mesh, k_fuse=2)
    _exact(C_OUT, [x.numpy() for x in list(got[0]) + list(got[1:])],
           list(fin) + [uU, vU])


def test_no_mesh_on_the_card_launches_the_fused_kernel(monkeypatch):
    """mesh=None on CUDA tensors runs K1 on the whole grid (through
    `evp_solve_fused`), never the plain loop: the fake card here records
    the kernel's call and returns the plain solve's planes."""
    from cice_tpu_torch.kernels import evp as kevp
    args, kw = _port_b(_jax_b_problem(24, 16, ("cyclic", "open"), 3),
                       ("cyclic", "open"))
    ref = evp_solve(*args, **kw)
    calls = []

    def fake_cuda(*a, **k):
        calls.append(a[1].ndte)
        return torch.cat([x.reshape(-1, *x.shape[-2:]) for x in ref])

    monkeypatch.setattr(kevp, "_on_cuda", lambda t: True)
    monkeypatch.setattr(kevp, "evp_solve_cuda", fake_cuda)
    got = evp_solve_wide(*args, **kw, mesh=None)
    assert calls == [3]
    _exact(B_OUT, [x.numpy() for x in got], ref)


def test_unequal_tiles_are_refused():
    args, kw = _port_b(_jax_b_problem(24, 16, ("cyclic", "open"), 2),
                       ("cyclic", "open"))

    class Fake(Mesh):
        shape = (3, 5)
    with pytest.raises(ValueError, match="equal tiles"):
        evp_solve_wide(*args, **kw, mesh=Fake())


@pytest.mark.parametrize("grid_ice", ["B", "C"])
def test_model_steps_wide_halo_on_2x4_ranks(runs, grid_ice):
    """Two Model steps with evp_algorithm='wide_halo' on a 2x4 mesh equal
    two steps of the one-program solve bit for bit (the JAX test holds its
    sharded step to 1e-5)."""
    r = runs[f"model_{grid_ice}"]
    got = _ranks_agree(r)
    assert all(x["stats"]["istep"] == 2 for x in r)
    cfg = Config().with_overrides(**MODEL_BASE, **{"grid.grid_ice": grid_ice})
    m = Model(cfg, device="cpu")
    m.step()
    m.step()
    _exact([f"leaf_{i}" for i in range(len(got))], got, state_leaves(m.state))


def test_mesh_layout_matches_make_mesh(runs, devices8):
    """The rank grid is JAX's device grid for the same arguments (the
    curve order, auto_decomp's shape for a gx1 grid, the near-square
    default); each rank finds itself, its tile, its neighbours (None past
    an open edge, wrapped on a cyclic one) and its x-mirror."""
    ids = np.vectorize(lambda d: d.id)
    for kw, r in runs["layouts"]:
        want = ids(make_mesh(devices=jax.devices()[:8], **kw).devices)
        py, px = want.shape
        for rank, got in enumerate(r):
            assert got["backend"] == "gloo"
            np.testing.assert_array_equal(np.asarray(got["ranks"]), want)
            iy, ix = got["coords"]
            assert want[iy, ix] == rank
            ty, tx = 48 // py, 40 // px
            assert got["tile"] == (slice(iy * ty, (iy + 1) * ty),
                                   slice(ix * tx, (ix + 1) * tx))
            assert got["mirror"] == want[iy, px - 1 - ix]
            for (dy, dx, cyc), nb in got["neighbours"].items():
                jy, jx = iy + dy, ix + dx
                inside = 0 <= jy < py and 0 <= jx < px
                assert nb == (want[jy % py, jx % px] if inside or cyc
                              else None)
