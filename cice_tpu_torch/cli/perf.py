"""Performance suite: the perf_suite.ts analogue (PyTorch port of
cice_tpu/cli/perf.py).

The reference perf suite (configuration/scripts/tests/perf_suite.ts) sweeps
block sizes at one task, then MPI strong scaling, then thread scaling. Here
the axes are

  sizes  — grid-size sweep on one card (the block-size sweep analogue:
           how launch overheads amortize with the grid),
  strong — the second size on a growing number of cards,
  weak   — a fixed tile per card on a growing number of cards.

Each row times the B-grid EVP solve (ndte subcycles) through K1
(`kernels.evp.evp_solve_fused`: on the card the fused kernel, whose route,
`persistent` or `stream`, the row names; on the CPU its plain version) and
prints one JSON line. Scaling beyond one card waits for ROADMAP A8: a
device count above 1 raises, and nothing switches to CPU devices.
"""

from __future__ import annotations

import json
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


def run_perf(sizes=((192, 160), (384, 320), (768, 640)), ndte=120,
             mesh_devices=(1,), weak_tile=(192, 160), out=print,
             device="cuda", n_rep=5):
    """Run the sweeps on one device; returns the rows. A device count above
    1 in `mesh_devices` raises NotImplementedError (ROADMAP A8)."""
    if max(mesh_devices) > 1:
        raise NotImplementedError(
            f"perf across {max(mesh_devices)} devices needs the multi-GPU "
            "EVP (ROADMAP A8: multi-GPU); run with --mesh 1")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("perf on 'cuda' needs a CUDA device; pass "
                           "device='cpu' for the plain version on the CPU")
    rows = []

    def emit(row):
        rows.append(row)
        out(json.dumps(row))

    def row(sweep, ny, nx, **extra):
        tput, t = evp_throughput(ny, nx, ndte, n_rep, device)
        emit({"sweep": sweep, "grid": f"{ny}x{nx}", "devices": 1,
              "ndte": ndte, "device": str(device),
              "route": k1_route(ny, nx, device), "s_per_dynstep": t,
              "Mptsub_s": tput / 1e6, **extra})

    for ny, nx in sizes:
        row("sizes", ny, nx)
    ny, nx = sizes[min(1, len(sizes) - 1)]
    row("strong", ny, nx, mesh="1x1", efficiency=1.0)
    row("weak", *weak_tile, mesh="1x1", efficiency=1.0)
    return rows
