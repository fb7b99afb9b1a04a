"""Rank jobs that only the tests run across spawned gloo ranks
(`cice_tpu_torch.parallel.spawn.launch`): mesh layouts, sharded I/O, the
tile-aware halo functions and a rank that leaves out a shift, the VP
operator on a padded tile, therm1's temperature solve on a rank's tile,
and the launcher's own tests.

The ranks import this module to find the jobs, so it imports pytest,
torch and the port only, never JAX (test_torch_evp_wide.py and
test_torch_pio.py, which launch these jobs, do).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import torch.distributed as dist  # noqa: E402

from cice_tpu_torch.calendar import Calendar  # noqa: E402
from cice_tpu_torch.convert import state_from_numpy  # noqa: E402
from cice_tpu_torch.io.pio import (read_restart_sharded,  # noqa: E402
                                   write_field_sharded,
                                   write_restart_sharded)
from cice_tpu_torch.model.state import state_leaves  # noqa: E402
from cice_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from cice_tpu_torch.parallel import spawn  # noqa: E402
from cice_tpu_torch.parallel.spawn import load, rank_result  # noqa: E402


def mesh_layout(*, group, shape=None, grid_shape=None, curve_order=False):
    """A Mesh's layout as this rank sees it: the rank grid, its
    coordinates, tile, neighbours (open and cyclic) and mirror."""
    mesh = Mesh(shape, grid_shape=grid_shape, curve_order=curve_order,
                group=group)
    nb = {(dy, dx, c): mesh.neighbour(dy, dx, y_cyclic=c, x_cyclic=c)
          for dy in (-1, 0, 1) for dx in (-1, 0, 1) for c in (False, True)}
    return dict(ranks=mesh.ranks.tolist(), coords=mesh.coords,
                tile=mesh.tile_slices(48, 40), neighbours=nb,
                mirror=mesh.mirror(), backend=mesh.backend)


def _write_fields(fields, dirpath, mesh, device):
    return {name: write_field_sharded(
                dirpath, name, torch.as_tensor(a, device=device), mesh=mesh)
            for name, a in load(fields).items()}


def write_fields(*, group, fields, dirpath, shape, device="cpu"):
    """write_field_sharded of each field (a file of {name: array}), every
    rank its tile."""
    return _write_fields(fields, dirpath, Mesh(shape, group=group), device)


def write_restart(*, group, state, calendar, dirpath, shape, device="cpu",
                  pointer_file=None):
    """write_restart_sharded of a state ({field: array} as
    convert.state_to_numpy gives it) and a calendar (its fields)."""
    mesh = Mesh(shape, group=group)
    return write_restart_sharded(
        dirpath, state_from_numpy(load(state), device), Calendar(**calendar),
        pointer_file, mesh=mesh)


def write_on_last_ranks(*, group, nranks, fields, state, calendar, dirpath,
                        pointer_file, device="cpu"):
    """Fields and a restart from a 1 x nranks Mesh over the world's last
    `nranks` ranks, a group without rank 0; the other ranks return None."""
    world = dist.get_world_size()
    ranks = list(range(world - nranks, world))
    sub = dist.new_group(ranks)             # every rank takes part
    if dist.get_rank() not in ranks:
        return None
    mesh = Mesh((1, nranks), group=sub)
    return dict(
        fields=_write_fields(fields, dirpath, mesh, device),
        restart=write_restart_sharded(
            dirpath, state_from_numpy(load(state), device),
            Calendar(**calendar), pointer_file, mesh=mesh))


def read_restart(*, group, path, template, shape, device="cpu"):
    """read_restart_sharded on every rank of a `shape` mesh into a
    template state (a file as in `write_restart`)."""
    mesh = Mesh(shape, group=group)
    st, cal = read_restart_sharded(
        path, state_from_numpy(load(template), device))
    return rank_result(mesh, state_leaves(st), dict(istep=cal.istep))


#: the field locations and types a tripole fold tells apart
LOCS = ("center", "necorner", "eface", "nface")
FTYPES = ("scalar", "vector", "angle")


def halo_checks(*, group, shape, grid_shape, seed=0):
    """Every function of core.halo on this rank's tile (`Mesh.tile_bc`)
    against this rank's tile of its result on the whole array: `shift` for
    every (dj, di) in [-2, 2]^2, `neighbors4`, `extrapolate_edges` and
    `apply_closed_mask` (1 and 2 rows), for ew cyclic/open/closed times ns
    open/closed/cyclic/tripole/tripoleT, every location and type at a
    tripole seam. Returns {function: (cases, the cases not equal)}."""
    from cice_tpu_torch import constants as cst
    from cice_tpu_torch.core import halo
    loc = {"center": cst.FIELD_LOC_CENTER, "necorner": cst.FIELD_LOC_NECORNER,
           "eface": cst.FIELD_LOC_EFACE, "nface": cst.FIELD_LOC_NFACE}
    ftype = {"scalar": cst.FIELD_TYPE_SCALAR,
             "vector": cst.FIELD_TYPE_VECTOR, "angle": cst.FIELD_TYPE_ANGLE}
    mesh = Mesh(shape, group=group)
    ny, nx = grid_shape
    gen = torch.Generator().manual_seed(seed)
    f = torch.rand((2, ny, nx), generator=gen, dtype=torch.float64)
    out = {k: [0, []] for k in ("shift", "neighbors4", "extrapolate_edges",
                                "apply_closed_mask")}

    def check(what, want, got, case):
        out[what][0] += 1
        if not (len(want) == len(got) and
                all(torch.equal(a, b) for a, b in zip(want, got))):
            out[what][1].append(case)

    for ew in ("cyclic", "open", "closed"):
        for ns in ("open", "closed", "cyclic", "tripole", "tripoleT"):
            bc = halo.BC(ew, ns)
            tbc = mesh.tile_bc(bc, (ny, nx))
            ft = tbc.tile(f).contiguous()
            kinds = ([(lc, ty) for lc in LOCS for ty in FTYPES]
                     if bc.tripole else [("center", "scalar")])
            for lc, ty in kinds:
                kw = dict(loc=loc[lc], ftype=ftype[ty])
                for dj in range(-2, 3):
                    for di in range(-2, 3):
                        check("shift",
                              [tbc.tile(halo.shift(f, dj, di, bc=bc, **kw))],
                              [halo.shift(ft, dj, di, bc=tbc, **kw)],
                              (ew, ns, lc, ty, dj, di))
                check("neighbors4",
                      [tbc.tile(x) for x in halo.neighbors4(f, bc=bc, **kw)],
                      list(halo.neighbors4(ft, bc=tbc, **kw)),
                      (ew, ns, lc, ty))
            check("extrapolate_edges",
                  [tbc.tile(halo.extrapolate_edges(f, bc))],
                  [halo.extrapolate_edges(ft, tbc)], (ew, ns))
            for nrows in (1, 2):
                check("apply_closed_mask",
                      [tbc.tile(halo.apply_closed_mask(f, bc, nrows))],
                      [halo.apply_closed_mask(ft, tbc, nrows)],
                      (ew, ns, nrows))
    return {k: tuple(v) for k, v in out.items()}


def skip_a_shift(*, group):
    """On a 1x2 mesh rank 0 leaves out a shift that rank 1 makes: rank 1
    waits for a message that never comes."""
    from cice_tpu_torch.core import halo
    mesh = Mesh((1, 2), group=group)
    bc = mesh.tile_bc(halo.BC("cyclic", "open"), (4, 8))
    if mesh.rank == mesh.group_ranks[0]:
        return "skipped"
    return halo.shift(torch.zeros(4, 4), 0, 1, bc=bc)


def gather_unequal(*, group, shape, grid_shape):
    """shard_state then gather_state of a (3, ny, nx) array and a 0-d one
    on `shape` (tiles of unequal sizes where the shape does not divide)."""
    mesh = Mesh(shape, group=group)
    x = torch.arange(3 * grid_shape[0] * grid_shape[1],
                     dtype=torch.float64).reshape((3,) + tuple(grid_shape))
    tiles = mesh.shard_state({"x": x, "s": torch.tensor(2.0)})
    back = mesh.gather_state(tiles, grid_shape)
    return dict(tile=tuple(tiles["x"].shape), equal=torch.equal(back["x"], x),
                scalar=float(back["s"]))


def vp_problem(cfg, path, device="cpu", seed=0):
    """One Picard iteration's VP problem on `cfg`'s grid after one step of
    the model (the ice in motion), written to `path`: the B-grid EVP
    problem (`spawn.b_problem_to_numpy`) with a random iterate x and water
    drag vrel made from `seed`, and deltaminVP."""
    import numpy as np
    from cice_tpu_torch.columns.ridging import ice_strength
    from cice_tpu_torch.dynamics.common import evp_params
    from cice_tpu_torch.model.driver import Model
    from cice_tpu_torch.model.step import b_grid_prep
    m = Model(cfg, device=device)
    m.step()
    st, fc, dt = m.state, m.forcing, cfg.setup.dt
    prep, uocn, vocn = b_grid_prep(cfg, m.grid, st, fc, fc.strax, fc.stray,
                                   dt)
    strength = ice_strength(st.aicen, st.vicen, st.aice, st.vice,
                            cfg.dynamics)
    d = spawn.b_problem_to_numpy(m.grid, evp_params(cfg.dynamics, dt), prep,
                                 strength, st.stressp, st.stressm,
                                 st.stress12, uocn, vocn)
    rng = np.random.default_rng(seed)
    dtype = d["strength"].dtype
    d.update(x=rng.standard_normal((2,) + m.grid.shape).astype(dtype),
             vrel=(5.0 * rng.random(m.grid.shape)).astype(dtype),
             deltaminVP=cfg.dynamics.deltaminVP)
    return spawn.save(d, path)


def _vp_system(problem, device, mesh=None):
    """(grid, the system's outputs) of `vp_operator` on the whole grid, or
    on this rank's tile with `mesh`."""
    from cice_tpu_torch.dynamics import vp
    from cice_tpu_torch.dynamics.common import RHEO_AREA_MIN
    d = load(problem)
    (grid, p, prep, strength, *_), _ = spawn.b_problem_from_numpy(d, device)
    x = torch.as_tensor(d["x"], device=device)
    vrel = torch.as_tensor(d["vrel"], device=device)
    if mesh is not None:
        shp = grid.shape
        grid = mesh.tile_grid(grid)
        prep, strength, x, vrel = mesh.shard_state((prep, strength, x, vrel),
                                                   shp)
    st = vp.Stencil(grid, strength, d["deltaminVP"] * grid.tarea)
    rf = (prep.aiU > RHEO_AREA_MIN).to(x.dtype)
    sys_ = vp.linear_system(st, p, prep, prep.uvel, prep.vvel, vrel, rf)
    y = sys_.matvec(x)
    local = torch.sum(x * y)
    return st, [y, sys_.b, sys_.diag, vp.grid_sum(local, st.mesh),
                vp.grid_norm(y, st.mesh), local]


def vp_operator_whole(problem, device="cpu"):
    """[A x, b, diag, x . A x, |A x|, x . A x] on the whole grid."""
    return [t.cpu().numpy() for t in _vp_system(problem, device)[1]]


def vp_operator(*, group, problem, shape, device="cpu"):
    """One Picard iteration's VP system (`dynamics.vp.linear_system`) on
    this rank's tile of `problem` (vp_problem): A x, b and the diagonal
    gathered whole, the grid sums x . A x and |A x| (`grid_sum`,
    `grid_norm`), and every rank's partial of x . A x; the stencil's
    radius, the messages and the collectives as stats."""
    mesh = Mesh(shape, group=group)
    st, (y, b, diag, dot, norm, local) = _vp_system(problem, device, mesh)
    e0, c0 = mesh.exchanges, mesh.collectives
    ny, nx = st.bc.ny, st.bc.nx
    outs = [mesh.all_gather_tiles(t, ny, nx) for t in (y, b, diag)]
    outs += [dot, norm, mesh.all_gather(local)]
    return rank_result(mesh, outs, dict(radius=st.radius,
                                        exchanges=e0, collectives=c0,
                                        tile=tuple(y.shape[-2:])))


def vp_host_reads(*, group, cfg, shape):
    """implicit_solver on this rank's tiles of one Picard problem of
    `cfg`, with every Tensor.item, bool, float, int, tolist and numpy call
    counted; (the calls, the solve's u finite on the tile)."""
    from cice_tpu_torch.columns.ridging import ice_strength
    from cice_tpu_torch.dynamics import vp
    from cice_tpu_torch.model.driver import Model
    from cice_tpu_torch.model.step import b_grid_prep
    m = Model(cfg, device="cpu", mesh=Mesh(shape, group=group), shard=True)
    st, fc, dt = m.state, m.forcing, cfg.setup.dt
    prep, uocn, vocn = b_grid_prep(cfg, m.grid, st, fc, fc.strax + 0.1,
                                   fc.stray + 0.05, dt)
    strength = ice_strength(st.aicen, st.vicen, st.aice, st.vice,
                            cfg.dynamics)
    reads = []
    saved = {}
    for name in ("item", "__bool__", "__float__", "__int__", "tolist",
                 "numpy"):
        orig = saved[name] = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            reads.append(_name)
            return _orig(self, *a, **k)
        setattr(torch.Tensor, name, spy)
    try:
        out = vp.implicit_solver(m.grid, cfg.dynamics, prep, strength,
                                 uocn=uocn, vocn=vocn, dt=dt)
    finally:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)
    return reads, bool(torch.isfinite(out[0]).all()), \
        float(out[0].abs().max())


# ---------------------------------------------------------------------------
# therm1's temperature solve on a rank's tile
# ---------------------------------------------------------------------------

BL99_LISTS = ("qsno", "qice", "Iswabs")


def bl99_problem(dt, nilyr, nslyr, kw, path):
    """Save the arguments of `temperature_changes` (`kw`: its keywords) as
    arrays for `bl99_tiles`; returns the path."""
    d = dict(dt=dt, nilyr=nilyr, nslyr=nslyr)
    for k, v in kw.items():
        if k in BL99_LISTS:
            d[k] = [x.cpu().numpy() for x in v]
        elif isinstance(v, torch.Tensor):
            d[k] = v.cpu().numpy()
        elif k != "mesh":
            d[k] = v
    return spawn.save(d, path)


def _bl99_args(d, device, cut=lambda t: t):
    kw = {}
    for k, v in d.items():
        if k in BL99_LISTS:
            kw[k] = [cut(torch.as_tensor(x, device=device)) for x in v]
        elif hasattr(v, "shape"):
            kw[k] = cut(torch.as_tensor(v, device=device))
        else:
            kw[k] = v
    return kw.pop("dt"), kw.pop("nilyr"), kw.pop("nslyr"), kw


def _bl99_flat(out):
    ts, qsno_new, qice_new = out
    flat = []
    for v in ts:
        flat += list(v) if isinstance(v, list) else [v]
    return flat + list(qsno_new) + list(qice_new)


def bl99_whole(problem, device="cpu"):
    """`temperature_changes` on the whole grid of `problem`: its outputs
    flattened (TempSolveOut's fields, then qsno_new, qice_new)."""
    from cice_tpu_torch.columns.thermo_vertical import temperature_changes
    dt, nilyr, nslyr, kw = _bl99_args(load(problem), device)
    out = temperature_changes(dt, nilyr, nslyr, **kw)
    return [t.cpu().numpy() for t in _bl99_flat(out)]


def bl99_tiles(*, group, problem, shape, device="cpu"):
    """`temperature_changes` on this rank's tile of `problem`
    (`bl99_problem`) with the exit agreed across a `shape` mesh: on CUDA
    tensors K4's per-pass route. The outputs gathered whole; the Picard
    host reads and the launches by route of this rank as stats."""
    from cice_tpu_torch.columns.thermo_vertical import temperature_changes
    from cice_tpu_torch.kernels import launch_counts
    from cice_tpu_torch.utils.timers import sync_counts
    mesh = Mesh(shape, group=group)
    d = load(problem)
    ny, nx = d["Tsf"].shape[-2:]
    # contiguous tiles: on the CPU a vector loop's tail may round exp and
    # pow otherwise than its body, so the shapes must keep the same tails
    dt, nilyr, nslyr, kw = _bl99_args(d, device,
                                      lambda t: mesh.tile(t).contiguous())
    reads, launches = sync_counts().get("picard", 0), launch_counts()
    out = temperature_changes(dt, nilyr, nslyr, mesh=mesh, **kw)
    after = launch_counts()
    outs = [mesh.all_gather_tiles(t.contiguous(), ny, nx)
            for t in _bl99_flat(out)]
    return rank_result(mesh, outs, dict(
        picard=sync_counts().get("picard", 0) - reads,
        launches={k: n - launches[k] for k, n in after.items()
                  if n != launches[k]}))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("job", [("no_such_job", {}, 2), ("evp_b", {}, 0),
                                 ("evp_b", {}, 3), (42, {}, 1)])
def test_launch_refuses_what_it_cannot_run(job, tmp_path):
    with pytest.raises(ValueError, match="ranks"):
        spawn.launch([job], 2, str(tmp_path))


def test_jobs_by_name_and_by_function(tmp_path):
    """A job is a name in spawn.JOBS or a function of an importable module
    (here this one): each runs on its first n ranks, in a group of its own,
    and the others give None."""
    res = spawn.launch([(mesh_layout, dict(shape=(1, 2)), 2),
                        (mesh_layout, dict(), 1)], 2, str(tmp_path),
                       timeout=120.0)
    assert [r["coords"] for r in res[0]] == [(0, 0), (0, 1)]
    assert [r["backend"] for r in res[0]] == ["gloo", "gloo"]
    assert res[1][0]["ranks"] == [[0]] and res[1][1] is None
    assert set(spawn.JOBS) == {"evp_b", "evp_c", "model_steps",
                               "global_sums", "sharded_steps",
                               "evp_sharded"}
