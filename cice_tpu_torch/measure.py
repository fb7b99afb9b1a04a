"""What the port's measurement scripts share (chip_smoke.py,
tune_kernels.py): the CUDA-event timer, the card's name and power limit,
and the EVP inputs K1 is held against its plain version on.
"""

from __future__ import annotations

import subprocess

import torch

from .columns.ridging import ice_strength
from .dynamics.common import dyn_prep, evp_params


def timed_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call by CUDA events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def gpu_name_and_power_limit() -> str:
    """The first card's line of `nvidia-smi --query-gpu=name,power.limit`."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def evp_problem(grid, cfg_dyn, dt, dev, ndte=None):
    """(args, kwargs) of one `evp_solve` on `grid`: random ice on every
    ocean cell, at rest under a uniform wind, and random incoming stresses
    of 1e3 N/m on every cell, land included, so that a solve must mask them
    where there is no ice. Made from seed 0."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    rand = lambda *s: torch.rand(*s, generator=gen)
    aice = torch.clamp(0.5 + 0.5 * rand(grid.shape), 0, 1).to(dev) * \
        grid.tmask.to(torch.float32)
    vice = aice * 2.0
    z = torch.zeros(grid.shape, device=dev)
    prep = dyn_prep(grid, cfg_dyn, dt, aice=aice, vice=vice, vsno=z,
                    aiceU_prev_mask=torch.zeros(grid.shape, dtype=torch.bool,
                                                device=dev),
                    uvel=z, vvel=z, strairxT=z + 0.1, strairyT=z + 0.05,
                    uocn_T=z, vocn_T=z, ss_tltx_T=z, ss_tlty_T=z)
    p = evp_params(cfg_dyn, dt)
    if ndte is not None:
        p = p._replace(ndte=ndte)
    strength = ice_strength(torch.stack([aice / 5] * 5),
                            torch.stack([vice / 5] * 5), aice, vice, cfg_dyn)
    sp, sm, s12 = ((2e3 * rand((4,) + grid.shape) - 1e3).to(dev)
                   for _ in range(3))
    return (grid, p, prep, strength, sp, sm, s12), dict(uocn=z, vocn=z)
