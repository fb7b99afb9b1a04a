"""What the port's measurement scripts and tests share (chip_smoke.py,
tune_kernels.py, tests/test_torch_kernels_cuda.py): the CUDA-event timer,
the card's name and power limit, the EVP inputs K1 is held against its
plain version on (synthetic, or a model state's), the transport inputs of
a model state, the dense transport case K2 and K3 are timed on, and
counts of the PyTorch operations and host reads a call makes.
"""

from __future__ import annotations

import subprocess

import torch

from .columns.ridging import ice_strength
from .dynamics.common import dyn_prep, evp_params

# H100 SXM data sheet: HBM rate and f32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_ms(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time one H100 SXM could
    take to move `nbytes` and do `flops` in f32, and which binds."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS_PER_S * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


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


def dense_transport_case(grid, table, ncat: int, dev, seed: int = 3):
    """(grid, mom_n, mom_e, am, trm, table) of one transport pass where the
    ice moves everywhere: up to 0.15 of random ice per category on every
    ocean cell, tracers in [0.5, 2.5) and velocities of up to 0.3 cells per
    hour in random directions on every cell, made from `seed`. Beside the
    gx1pop state, where the ice moves in the polar caps only, it is the
    other end of what the kernels leave out (kernels/remap.py
    `work_fractions`: at gx1, 1.74 of 6 donor candidates per edge count and
    70.6% of the cells are needed, against 0.315 and 16.2%)."""
    from .dynamics import remap_exact as rx
    ny, nx = grid.shape
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *s: torch.rand(*s, generator=gen).to(dev)
    aicen = 0.15 * rnd(ncat, ny, nx) * grid.hm
    am = torch.cat([1.0 - aicen.sum(0, keepdim=True), aicen]).contiguous()
    trm = (2.0 * rnd(ncat, len(table), ny, nx) + 0.5).contiguous()
    u = 0.3 * grid.dxU / 3600.0 * (2.0 * rnd(ny, nx) - 1.0)
    v = 0.3 * grid.dyU / 3600.0 * (2.0 * rnd(ny, nx) - 1.0)
    dxs, dys, _ = rx.departure_points_scaled(grid, u, v, 3600.0, True)
    mom_n, mom_e = (t.contiguous() for t in rx.edge_moments(grid, dxs, dys))
    return grid, mom_n, mom_e, am, trm, table


def flux_case(grid, mom_n, mom_e, am, trm, table):
    """(args, tstack) of the flux-only kernel on one transport pass's
    inputs, reconstructed as `horizontal_remap_exact` does: args are
    (grid, mom_n, mom_e, mc, mx, my, tc, tx, ty, table)."""
    from .dynamics import remap_exact as rx
    mc, mx, my, tc, tx, ty, tstack = rx.construct_fields(grid, am, trm,
                                                         table, grid.hm)
    return (grid, mom_n, mom_e, mc, mx, my, tc, tx, ty, table), tstack


def evp_state_problem(ms, grid, state, fc, strairx, strairy, dt):
    """(args, kwargs) of the B-grid EVP solve that `step_dyn_horiz` makes
    of a model state, for holding K1 against `evp_solve` on that state."""
    from .model.step import b_grid_prep
    d = ms.cfg.dynamics
    prep, uocn, vocn = b_grid_prep(ms.cfg, grid, state, fc, strairx,
                                   strairy, dt)
    strength = ice_strength(state.aicen, state.vicen, state.aice,
                            state.vice, d)
    return (grid, evp_params(d, dt), prep, strength, state.stressp,
            state.stressm, state.stress12), dict(uocn=uocn, vocn=vocn)


def transport_state_problem(ms, grid, state, dt):
    """(grid, mom_n, mom_e, am, trm, table) of the exact-remap pass that
    `horizontal_remap_exact` makes of a B-grid state: the edge moments of
    its departure points and its tracer stack. Returns it and the largest
    departure (cells)."""
    from .dynamics import remap_exact as rx
    dxs, dys, _ = rx.departure_points_scaled(
        grid, state.uvel, state.vvel, dt, ms.cfg.dynamics.l_dp_midpt)
    mom_n, mom_e = (t.contiguous() for t in rx.edge_moments(grid, dxs,
                                                             dys))
    table = rx.build_flat_table(ms.registry)
    am, trm = rx.state_to_tracers(state, ms.registry, table)
    moving = float(torch.sqrt(dxs ** 2 + dys ** 2).max())
    return (grid, mom_n, mom_e, am, trm, table), moving


def therm1_problem(m, edit=None):
    """(dt, nilyr, nslyr, keywords) that `step_therm1` hands
    `temperature_changes` on the next step of Model `m` (the step is
    taken), without `ktherm` and `mesh`; `edit(state)` may change `m`'s
    state first."""
    from .model import step as tstep
    if edit is not None:
        m.state = edit(m.state)
    got = []
    real = tstep.temperature_changes

    def spy(dt, nilyr, nslyr, **kw):
        got.append((dt, nilyr, nslyr, dict(kw)))
        return real(dt, nilyr, nslyr, **kw)
    tstep.temperature_changes = spy
    try:
        m.step()
    finally:
        tstep.temperature_changes = real
    dt, nilyr, nslyr, kw = got[0]
    kw.pop("ktherm")
    kw.pop("mesh")
    return dt, nilyr, nslyr, kw


def count_ops(fn) -> int:
    """The PyTorch operations `fn()` dispatches (aten calls, views
    included): an upper count of the kernel launches a call of eager code
    makes besides the hand-written kernels' own."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def count_host_reads(fn) -> int:
    """The tensor-to-Python conversions (`bool`, `float`, `int`, `.item()`,
    `.tolist()`) `fn()` makes: on the card each one waits for the device.
    The global exit tests of the coupled step make one per Picard pass, per
    ridging pass and per `rebin` category move; the point probes one per
    call. Counted from outside the program, which counts its own by site
    (`core.reductions.host_read`, `utils.timers.sync_counts`)."""
    names = ("__bool__", "__float__", "__int__", "item", "tolist")
    saved = {nm: getattr(torch.Tensor, nm) for nm in names}
    count = [0]

    def counting(f):
        def call(self, *a, **k):
            count[0] += 1
            return f(self, *a, **k)
        return call

    try:
        for nm, f in saved.items():
            setattr(torch.Tensor, nm, counting(f))
        fn()
    finally:
        for nm, f in saved.items():
            setattr(torch.Tensor, nm, f)
    return count[0]


def step_counts(opts: str = "", device: str = "cuda") -> tuple:
    """(PyTorch operations, host reads) of one `Model.step` of
    `config.gx1pop_step(48, 40)` on `device` with the comma-separated option
    sets `opts` of the CLI's table (or `--set`-style 'key=value' items),
    after one warm step. On the CPU the step runs the plain EVP and
    transport where the card launches K1 and K2, so the CPU's count is
    higher by their plain operations."""
    from .cli.main import OPTION_SETS, _parse_sets
    from .config import gx1pop_step
    from .model.driver import Model
    cfg = gx1pop_step(48, 40)
    for opt in filter(None, opts.split(",")):
        over = _parse_sets([opt]) if "=" in opt else OPTION_SETS[opt]
        cfg = cfg.with_overrides(**over)
    m = Model(cfg, device=device)
    m.step()
    return count_ops(m.step), count_host_reads(m.step)


if __name__ == "__main__":
    # python -m cice_tpu_torch.measure [--device cpu] [opts ...]: operations
    # and host reads per coupled step of gx1pop_step at 48x40, for each
    # argument (an option set, a comma list of them, or key=value)
    import argparse
    ap = argparse.ArgumentParser(prog="python -m cice_tpu_torch.measure")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args()
    torch.set_num_threads(2)
    for opts in [""] + args.opts:
        ops, reads = step_counts(opts, args.device)
        print(f"gx1pop_step(48, 40){' + ' + opts if opts else ''} on "
              f"{args.device}: {ops} PyTorch operations, {reads} host "
              f"reads per step")
