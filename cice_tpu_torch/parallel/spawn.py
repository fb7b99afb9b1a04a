"""Rank workers: run jobs on several processes joined by gloo.

    results = launch(jobs, world=8, workdir=tmpdir)

`launch` starts `world` processes (start method `spawn`), joins them in a
gloo process group (or NCCL, `backend='nccl'`, rank r on card r) over a
`file://` rendezvous in `workdir` (no port to collide with another run's),
and runs every job on every rank in order. A
job is (fn, kwargs, nranks): `fn`, a name in `JOBS` or a function defined
at the top of a module, runs on ranks 0 .. nranks-1 in a group of their
own and gets that group as `group=`; the other ranks skip it. `launch`
returns, per job, the list of the ranks' results (None where a rank
skipped), and raises with the failing rank's traceback if one raised, or
TimeoutError. The process group waits `group_timeout` seconds for a peer
(60 by default), so a rank left waiting by a peer that took another branch
fails within a minute.

The processes start from a fresh interpreter with the caller's `sys.path`
and import torch, this package and the module of each job's function, so
a job's module must not import what the ranks should not load (a module
of tests that imports JAX). Inputs too large for the arguments travel as
files that `save` writes and `load` reads (pickles this package writes
itself). The ranks may share one CUDA device: each job names its
`device`.

`JOBS` holds what `chip_smoke.py` phases 14-16 and the CLI's `test
--type decomp` and `perf --mesh` run across ranks: the wide-halo EVP on the
B and C grids, whole model steps (the state whole on every rank, or
sharded), EVP solves on a sharded state, and global sums.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import queue
import time
import traceback
import uuid

import numpy as np
import torch


def save(obj, path: str) -> str:
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
    return path


def load(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def digest(arrays) -> str:
    """sha1 of a sequence of arrays' bytes (to hold the ranks' copies of a
    result equal without sending each one)."""
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# EVP problems as NumPy, so that any process can rebuild them
# ---------------------------------------------------------------------------

def b_problem_to_numpy(grid, p, prep, strength, stressp, stressm, stress12,
                       uocn, vocn) -> dict:
    from ..convert import dynprep_to_numpy, grid_to_numpy
    return dict(grid=grid_to_numpy(grid), bc=(grid.bc.ew, grid.bc.ns),
                p=tuple(p), prep=dynprep_to_numpy(prep),
                **{k: _np(v) for k, v in dict(
                    strength=strength, stressp=stressp, stressm=stressm,
                    stress12=stress12, uocn=uocn, vocn=vocn).items()})


def b_problem_from_numpy(d: dict, device):
    """(args, kwargs) of `evp_solve` on `device`."""
    from ..convert import dynprep_from_numpy, grid_from_numpy
    from ..core.halo import BC
    from ..dynamics.common import EvpParams
    t = lambda k: torch.as_tensor(d[k], device=device)
    grid = grid_from_numpy(d["grid"], BC(*d["bc"]), device)
    return ((grid, EvpParams(*d["p"]), dynprep_from_numpy(d["prep"], device),
             t("strength"), t("stressp"), t("stressm"), t("stress12")),
            dict(uocn=t("uocn"), vocn=t("vocn")))


def c_problem_to_numpy(grid, p, prep, strength, stresspT, stressmT,
                       stress12U) -> dict:
    from ..convert import grid_to_numpy
    return dict(grid=grid_to_numpy(grid), bc=(grid.bc.ew, grid.bc.ns),
                p=tuple(p), cprep=[_np(x) for x in prep],
                strength=_np(strength), stresspT=_np(stresspT),
                stressmT=_np(stressmT), stress12U=_np(stress12U))


def c_problem_from_numpy(d: dict, device):
    """The arguments of `evp_c_solve` on `device`."""
    from ..convert import grid_from_numpy
    from ..core.halo import BC
    from ..dynamics.common import EvpParams
    from ..dynamics.evp_c import CPrep
    t = lambda a: torch.as_tensor(a, device=device)
    grid = grid_from_numpy(d["grid"], BC(*d["bc"]), device)
    return (grid, EvpParams(*d["p"]), CPrep(*(t(x) for x in d["cprep"])),
            t(d["strength"]), t(d["stresspT"]), t(d["stressmT"]),
            t(d["stress12U"]))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rank_result(mesh, outs, stats=None) -> dict:
    """Rank 0 returns the arrays; every rank their digest, and `stats`."""
    arrays = [_np(x) for x in outs]
    return dict(digest=digest(arrays), stats=stats or {},
                out=arrays if mesh.rank == mesh.group_ranks[0] else None)


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def _job_evp_b(*, group, problem, shape, k_fuse, device="cpu", repeat=1):
    """evp_solve_wide on a `shape` mesh; `repeat` solves, the stats of the
    last one (host clock after a synchronise; K1 launches; the mesh's
    staging, card-wait and wire counters)."""
    from ..kernels import evp as kevp
    from .evp_wide import _chunks, _tile_geometry, evp_solve_wide
    from .mesh import Mesh
    args, kw = b_problem_from_numpy(load(problem), device)
    mesh = Mesh(shape, group=group)
    for _ in range(repeat):
        _sync(device)
        n0, e0 = kevp.launches, mesh.exchanges
        b0, s0 = mesh.staged_bytes, mesh.staged_seconds
        w0, r0 = mesh.wait_seconds, mesh.wire_seconds
        t0 = time.perf_counter()
        out = evp_solve_wide(*args, **kw, mesh=mesh, k_fuse=k_fuse)
        _sync(device)
        sec = time.perf_counter() - t0
    p = args[1]
    _, _, k, H = _tile_geometry(mesh, args[0].shape, 1, k_fuse, p.ndte)
    stats = dict(seconds=sec, k1_launches=kevp.launches - n0,
                 persistent=kevp.persistent_launches,
                 stream=kevp.stream_launches, k=k, halo=H,
                 refreshes=len(_chunks(p.ndte, k)) + 1,
                 exchanges=mesh.exchanges - e0,
                 staged_bytes=mesh.staged_bytes - b0,
                 staged_seconds=mesh.staged_seconds - s0,
                 wait_seconds=mesh.wait_seconds - w0,
                 wire_seconds=mesh.wire_seconds - r0,
                 coords=mesh.coords)
    return rank_result(mesh, out, stats)


def _job_evp_c(*, group, problem, shape, k_fuse, device="cpu", repeat=1):
    """evp_c_solve_wide on a `shape` mesh: the final state's five planes,
    then uvelU and vvelU."""
    from .evp_wide import evp_c_solve_wide
    from .mesh import Mesh
    args = c_problem_from_numpy(load(problem), device)
    mesh = Mesh(shape, group=group)
    for _ in range(repeat):
        _sync(device)
        t0 = time.perf_counter()
        final, uU, vU = evp_c_solve_wide(*args, mesh=mesh, k_fuse=k_fuse)
        _sync(device)
        sec = time.perf_counter() - t0
    return rank_result(mesh, list(final) + [uU, vU],
                   dict(seconds=sec, exchanges=mesh.exchanges))


def _job_model_steps(*, group, cfg, nsteps, shape, device="cpu",
                     write_restart=False):
    """`nsteps` Model steps on a `shape` mesh (a dump at the end with
    `write_restart`); the state's leaves, the K1 launches, the restart's
    path."""
    from ..kernels import evp as kevp
    from ..model.driver import Model
    from ..model.state import state_leaves
    from .mesh import Mesh
    mesh = Mesh(shape, group=group)
    m = Model(cfg, device=device, mesh=mesh)
    n0 = kevp.launches
    t0 = time.perf_counter()
    for _ in range(nsteps):
        m.step()
    sec = (time.perf_counter() - t0) / nsteps
    path = m.write_restart() if write_restart else None
    m.flush_io()
    return rank_result(mesh, state_leaves(m.state),
                   dict(k1_launches=kevp.launches - n0, restart=path,
                        istep=m.calendar.istep, seconds_per_step=sec,
                        exchanges=mesh.exchanges,
                        staged_bytes=mesh.staged_bytes,
                        staged_seconds=mesh.staged_seconds,
                        wait_seconds=mesh.wait_seconds,
                        wire_seconds=mesh.wire_seconds))


def _counters(mesh) -> dict:
    from ..kernels import bl99 as kbl99
    from ..kernels import evp as kevp
    from ..kernels import remap as kremap
    return dict(k1_launches=kevp.launches, k2_launches=kremap.launches,
                k3_launches=kremap.flux_launches,
                k4_whole_launches=kbl99.whole_launches,
                k4_per_pass_launches=kbl99.per_pass_launches,
                exchanges=mesh.exchanges,
                collectives=mesh.collectives, staged_bytes=mesh.staged_bytes,
                staged_seconds=mesh.staged_seconds,
                wait_seconds=mesh.wait_seconds,
                wire_seconds=mesh.wire_seconds)


def _job_sharded_steps(*, group, cfg, nsteps, shape, device="cpu",
                       write_restart=False, history=False):
    """`nsteps` Model steps with the state sharded on a `shape` mesh (a
    dump at the end with `write_restart`, history with `history`); the
    whole state's leaves, gathered, and per rank the kernels' launches, the
    messages, the collectives, the bytes staged and the seconds of the
    steps (host clock after a synchronise) with their split into staging
    copies, waits for the card and gloo calls, as totals over the steps."""
    from ..model.driver import Model
    from ..model.state import state_leaves
    from .mesh import Mesh
    mesh = Mesh(shape, group=group)
    m = Model(cfg, device=device, mesh=mesh, shard=True,
              enable_history=history)
    _sync(device)
    c0 = _counters(mesh)
    t0 = time.perf_counter()
    for _ in range(nsteps):
        m.step()
    _sync(device)
    sec = time.perf_counter() - t0
    stats = {k: v - c0[k] for k, v in _counters(mesh).items()}
    path = m.write_restart() if write_restart else None
    m.flush_io()
    stats.update(seconds=sec, steps=nsteps, coords=mesh.coords,
                 tile=tuple(m.grid.shape), restart=path,
                 istep=m.calendar.istep)
    return rank_result(mesh, state_leaves(m.gather_state()), stats)


def _job_evp_sharded(*, group, problem, shape, k_fuse, algo, device="cpu",
                     repeat=1):
    """One EVP solve on a sharded state of a `shape` mesh, `repeat` times:
    'wide' the wide-halo solve on the tiles (K1 on each padded tile on the
    card), 'plain' the plain loop through the tile-aware shift (a message
    per shift). Returns the gathered outputs, the best solve's seconds and
    the last solve's launches and messages."""
    from ..dynamics.evp import evp_solve
    from .evp_wide import evp_solve_wide
    from .mesh import Mesh
    (grid, p, *fields), kw = b_problem_from_numpy(load(problem), device)
    mesh = Mesh(shape, group=group)
    shp = grid.shape
    args = (mesh.tile_grid(grid), p, *mesh.shard_state(fields, shp))
    kw = mesh.shard_state(kw, shp)
    best = float("inf")
    for _ in range(repeat):
        _sync(device)
        c0 = _counters(mesh)
        t0 = time.perf_counter()
        out = (evp_solve_wide(*args, **kw, mesh=mesh, k_fuse=k_fuse)
               if algo == "wide" else evp_solve(*args, **kw))
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    stats = {k: v - c0[k] for k, v in _counters(mesh).items()}
    stats.update(seconds=best, coords=mesh.coords)
    return rank_result(mesh, [mesh.all_gather_tiles(x, *shp) for x in out],
                       stats)


def _job_global_sums(*, group, fields, shape, modes, device="cpu"):
    """{name: {mode: sum}} of global_sum over this rank's tile of each
    field (a file of {name: array}) on a `shape` mesh."""
    from ..core.reductions import global_sum
    from .mesh import Mesh
    mesh = Mesh(shape, group=group)
    out = {}
    for name, a in load(fields).items():
        x = mesh.tile(torch.as_tensor(a, device=device))
        out[name] = {m: global_sum(x, bfbflag=m, mesh=mesh).item()
                     for m in modes}
    return out


JOBS = {"evp_b": _job_evp_b, "evp_c": _job_evp_c,
        "model_steps": _job_model_steps, "global_sums": _job_global_sums,
        "sharded_steps": _job_sharded_steps,
        "evp_sharded": _job_evp_sharded}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _child(rank, world, init_file, jobs, q, group_timeout, backend):
    import torch.distributed as dist
    torch.set_num_threads(1)
    wait = datetime.timedelta(seconds=group_timeout)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world, timeout=wait)
        results = []
        for fn, kw, n in jobs:
            # every rank takes part in making each group
            group = (dist.new_group(list(range(n)), timeout=wait)
                     if n < world else None)
            fn = JOBS[fn] if isinstance(fn, str) else fn
            results.append(fn(group=group, **kw) if rank < n else None)
        q.put((rank, results, None))
    except BaseException:          # reported to the parent, then re-raised
        q.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(jobs, world: int, workdir: str, *, timeout: float = 600.0,
           group_timeout: float = 60.0, backend: str = "gloo") -> list:
    """Run `jobs` on `world` spawned ranks (one CPU thread each); returns
    [per job: [per rank: result]]. `group_timeout`: seconds a rank waits
    for a peer in any message or collective (ranks that skip a job wait
    for the others at the next job's group)."""
    import torch.multiprocessing as mp
    for fn, _, n in jobs:
        if not (callable(fn) or fn in JOBS) or not 1 <= n <= world:
            raise ValueError(f"job {fn!r} on {n} of {world} ranks")
    os.makedirs(workdir, exist_ok=True)
    init_file = os.path.join(os.path.abspath(workdir),
                             f"rendezvous_{uuid.uuid4().hex}")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_child,
                         args=(r, world, init_file, jobs, q,
                               group_timeout, backend))
             for r in range(world)]
    for pr in procs:
        pr.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, res, err = q.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, pr in enumerate(procs)
                        if r not in got and pr.exitcode is not None]
                if dead:
                    raise RuntimeError(
                        f"ranks {dead} ended without a result (exit codes "
                        f"{[procs[r].exitcode for r in dead]})") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world - len(got)} of {world} ranks gave no "
                        f"result within {timeout:.0f} s") from None
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} failed:\n{err}")
            got[rank] = res
    finally:
        for pr in procs:
            pr.join(timeout=10.0 if len(got) == world else 0.1)
            if pr.is_alive():
                pr.terminate()
                pr.join(timeout=10.0)
        if os.path.exists(init_file):
            os.remove(init_file)
    return [[got[r][j] for r in range(world)] for j in range(len(jobs))]
