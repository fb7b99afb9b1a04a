"""Performance suite: the perf_suite.ts analogue (PyTorch port of
cice_tpu/cli/perf.py).

The reference perf suite (configuration/scripts/tests/perf_suite.ts) sweeps
block sizes at one task, then MPI strong scaling, then thread scaling. Here
the axes are

  sizes  — grid-size sweep on one card (the block-size sweep analogue:
           how launch overheads amortize with the grid),
  strong — the second size on a growing number of cards,
  weak   — a fixed tile per card on a growing number of cards.

Each row times the B-grid EVP solve (ndte subcycles) and prints one JSON
line. On one rank the solve goes through K1 (`kernels.evp.evp_solve_fused`:
on the card the fused kernel, whose route, `persistent` or `stream`, the
row names; on the CPU its plain version). On n > 1 ranks (spawned
processes, parallel/spawn.py) the EVP inputs are sharded across a
near-square mesh of them, and each row of the JAX package's two becomes
one here: 'standard_2d', the plain loop through the tile-aware shift (a
message per neighbour access, what GSPMD partitions), and 'wide_halo', the
wide-halo solve on the tiles (K1 on each padded tile on the card, k
subcycles per exchange). The ranks are joined by gloo where they share a
card (or run on the CPU) and by NCCL where each has its own; the row names
the backend and the cards. Nothing switches to CPU devices.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch


def _setup(ny, nx, ndte, device, dtype=torch.float32, seed=0):
    """The EVP solve's inputs on an all-ocean (ny, nx) rectangular grid:
    ice between 0.5 and 1 (made with numpy from `seed`), 2 m thick, at rest
    under a uniform wind stress."""
    from ..columns.ridging import ice_strength
    from ..config import Config
    from ..core.grid import rectgrid
    from ..dynamics.common import dyn_prep, evp_params

    cfg = Config().with_overrides(**{
        "grid.nx_global": nx, "grid.ny_global": ny,
        "dynamics.ndte": ndte, "dynamics.coriolis": "latitude"})
    grid = rectgrid(nx, ny, kmt_type="none", dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    aice = torch.as_tensor(np.clip(0.5 + 0.5 * rng.random((ny, nx)),
                                   0.0, 1.0), dtype=dtype, device=device)
    vice = aice * 2.0
    z = torch.zeros((ny, nx), dtype=dtype, device=device)
    prep = dyn_prep(grid, cfg.dynamics, cfg.setup.dt, aice=aice, vice=vice,
                    vsno=z, aiceU_prev_mask=torch.zeros(
                        (ny, nx), dtype=torch.bool, device=device),
                    uvel=z, vvel=z, strairxT=z + 0.1, strairyT=z + 0.05,
                    uocn_T=z, vocn_T=z, ss_tltx_T=z, ss_tlty_T=z)
    p = evp_params(cfg.dynamics, cfg.setup.dt)
    strength = ice_strength(torch.stack([aice / 5] * 5),
                            torch.stack([vice / 5] * 5), aice, vice,
                            cfg.dynamics)
    z3 = torch.zeros((4, ny, nx), dtype=dtype, device=device)
    return (grid, p, prep, strength, z3, z3, z3), dict(uocn=z, vocn=z)


def k1_route(ny: int, nx: int, device) -> str:
    """The route K1 takes for an (ny, nx) grid on `device`: 'persistent'
    or 'stream' on the card, 'plain' (its PyTorch version) on the CPU."""
    if torch.device(device).type != "cuda":
        return "plain"
    from ..kernels import evp as kevp
    info = kevp.device_info(torch.device(device).index or 0)
    return kevp.choose_route(ny, nx, info["sm_count"],
                             info["smem_per_block"],
                             info["blocks_per_sm"])[0]


def evp_throughput(ny, nx, ndte=120, n_rep=5, device="cuda"):
    """(grid-point·subcycles per second, best seconds per solve) of the EVP
    solve through K1 on one device, best of `n_rep` after one warm call."""
    from ..kernels.evp import evp_solve_fused
    args, kw = _setup(ny, nx, ndte, device)
    cuda = torch.device(device).type == "cuda"

    def run():
        out = evp_solve_fused(*args, **kw)
        if cuda:
            torch.cuda.synchronize()
        return out

    run()
    best = float("inf")
    for _ in range(n_rep):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return ny * nx * ndte / best, best


def _mesh_runs(runs, ndte, device, n_rep, k_fuse=8):
    """{(sweep, n, algo): (best seconds, mesh shape, backend)} of the EVP
    on a sharded state for each (sweep, n, (ny, nx)) of `runs`, on
    spawned ranks (one launch for all)."""
    from ..parallel import spawn
    from ..parallel.mesh import near_square
    world = max(n for _, n, _ in runs)
    cuda = torch.device(device).type == "cuda"
    own_cards = cuda and torch.cuda.device_count() >= world
    backend = "nccl" if own_cards else "gloo"
    jobs, keys = [], []
    with tempfile.TemporaryDirectory() as wd:
        for sweep, n, (ny, nx) in runs:
            args, kw = _setup(ny, nx, ndte, "cpu")
            path = spawn.save(spawn.b_problem_to_numpy(*args, **kw),
                              os.path.join(wd, f"{sweep}_{n}.pkl"))
            for algo in ("standard_2d", "wide_halo"):
                jobs.append(("evp_sharded", dict(
                    problem=path, shape=near_square(n), k_fuse=k_fuse,
                    algo="plain" if algo == "standard_2d" else "wide",
                    device=str(device), repeat=n_rep + 1), n))
                keys.append((sweep, n, algo))
        # ranks outside a smaller job wait for it at the next job's group
        res = spawn.launch(jobs, world, wd, backend=backend,
                           timeout=3600.0, group_timeout=600.0)
    return {k: (max(x["stats"]["seconds"] for x in r if x is not None),
                near_square(k[1]), backend)
            for k, r in zip(keys, res)}


def run_perf(sizes=((192, 160), (384, 320), (768, 640)), ndte=120,
             mesh_devices=(1,), weak_tile=(192, 160), out=print,
             device="cuda", n_rep=5):
    """Run the sweeps; returns the rows. Rank counts above 1 in
    `mesh_devices` run on spawned ranks with the state sharded."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("perf on 'cuda' needs a CUDA device; pass "
                           "device='cpu' for the plain version on the CPU")
    rows = []
    cards = (min(torch.cuda.device_count(), max(mesh_devices))
             if torch.device(device).type == "cuda" else 0)

    def emit(row):
        rows.append(row)
        out(json.dumps(row))

    def row(sweep, ny, nx, **extra):
        tput, t = evp_throughput(ny, nx, ndte, n_rep, device)
        emit({"sweep": sweep, "grid": f"{ny}x{nx}", "devices": 1,
              "ndte": ndte, "device": str(device),
              "route": k1_route(ny, nx, device), "s_per_dynstep": t,
              "Mptsub_s": tput / 1e6, **extra})
        return tput

    for ny, nx in sizes:
        row("sizes", ny, nx)
    strong = sizes[min(1, len(sizes) - 1)]
    ty, tx = weak_tile
    from ..parallel.mesh import near_square
    grids = {"strong": lambda n: strong,
             "weak": lambda n: (ty * near_square(n)[0],
                                tx * near_square(n)[1])}
    many = [n for n in mesh_devices if n > 1]
    timed = _mesh_runs([(sw, n, grids[sw](n)) for sw in grids
                        for n in many], ndte, device, n_rep) if many else {}
    for sweep in grids:
        anchor = None
        for n in mesh_devices:
            ny, nx = grids[sweep](n)
            if n == 1:
                anchor = row(sweep, ny, nx, mesh="1x1", efficiency=1.0,
                             backend=None, cards=min(cards, 1))
                continue
            for algo in ("standard_2d", "wide_halo"):
                t, (py, px), backend = timed[(sweep, n, algo)]
                tput = ny * nx * ndte / t
                emit({"sweep": sweep, "algo": algo, "grid": f"{ny}x{nx}",
                      "devices": n, "mesh": f"{py}x{px}", "ndte": ndte,
                      "device": str(device), "backend": backend,
                      "cards": cards, "s_per_dynstep": t,
                      "Mptsub_s": tput / 1e6,
                      "efficiency": (tput / (anchor * n) if anchor
                                     else None)})
    return rows
