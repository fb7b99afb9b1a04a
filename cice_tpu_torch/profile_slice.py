"""Profile gx1pop steps on one GPU.

    python -m cice_tpu_torch.profile_slice [--steps 3] [--path step|auto|dyn]

Runs one warmup step, then traces `steps` steps with torch.profiler:
`--path step` (default) the full coupled step of `gx1pop_step` (Model.run,
K1 + K3), `--path auto` the same with remap_kernel='auto' (K1 + K2),
`--path dyn` the dynamics-transport supercycle of `gx1pop_dyn`
(Model.run_dynamics, K1 + K2). Prints the device time of the hand-written
kernels (K1 = evp_*_kernel, K2 = transport_kernel, K3 =
tracer_fluxes_kernel) and of everything else (PyTorch's own kernels for the
plain parts of the path), the top kernels by device time, and the device
busy share of the traced window (kernel time over host wall time; kernels
of one stream never overlap). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--path", choices=("step", "auto", "dyn"),
                    default="step")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from . import config as C
    from .kernels import _build
    from .measure import gpu_name_and_power_limit
    from .model.driver import Model

    _build.build()
    print(gpu_name_and_power_limit())
    if args.path == "dyn":
        m = Model(C.gx1pop_dyn(), device="cuda")
        run = m.run_dynamics
    else:
        kernel = "auto" if args.path == "auto" else "fused_pallas"
        m = Model(C.gx1pop_step(remap_kernel=kernel).with_overrides(
            **{"setup.diagfreq": 0}), device="cuda")
        run = m.run
    run(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(args.steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    us = lambda e: e.self_device_time_total
    total = sum(us(e) for e in kernels)
    k1 = sum(us(e) for e in kernels if "evp_persistent_kernel" in e.key
             or "evp_stream_" in e.key)
    k2 = sum(us(e) for e in kernels if "transport_kernel" in e.key)
    k3 = sum(us(e) for e in kernels if "tracer_fluxes_kernel" in e.key)
    per = args.steps * 1e3
    print(f"path {args.path}, {args.steps} steps: wall "
          f"{wall_ms / args.steps:.3f} ms/step "
          f"(host clock, traced), device busy {total / per:.3f} ms/step "
          f"= {total / 1e3 / wall_ms:.1%} of wall")
    print(f"K1 evp kernels {k1 / per:.3f} ms/step, K2 transport kernel "
          f"{k2 / per:.3f} ms/step, K3 flux kernel {k3 / per:.3f} ms/step, "
          f"other (PyTorch) kernels {(total - k1 - k2 - k3) / per:.3f} "
          f"ms/step in "
          f"{sum(e.count for e in kernels) // args.steps} launches/step")
    for e in sorted(kernels, key=us, reverse=True)[:15]:
        print(f"  {us(e) / per:8.3f} ms/step  {e.count // args.steps:6d} "
              f"calls/step  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
