"""How far an option set's run moves under a 1e-15 change of its own
input, beside how far float32 moves it, step by step.

    python -m cice_tpu_torch.sensitivity --opts tx1pop --steps 24

Three Models of the option set (its grid and forcing fixtures, no history
and no restarts) step together: `base` in float64, `pert` in float64 with
`vicen` multiplied by 1 + 1e-15, and `f32` as the option set runs. After
each step it prints, for the dynamics leaves (uvel, vvel, the three
stresses) and vicen, the largest difference from `base` over the whole
grid and over the two northernmost rows (a tripole grid's fold), each
relative to `base`'s largest value of the leaf, and the `hmax` and `umax`
diagnostics of all three runs. The `pert` column is the run's own
envelope: a difference of that size is not a fault of either run.
`--out FILE` writes the records as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

LEAVES = ("uvel", "vvel", "stressp", "stressm", "stress12", "vicen")


def _rel(a: torch.Tensor, b: torch.Tensor, scale: float) -> tuple:
    d = (a.to(torch.float64) - b).abs()
    return (float(d.max()) / scale, float(d[..., -2:, :].max()) / scale)


def run(opts: str, steps: int, device: str, sets=()) -> list:
    from .cli import main as cli
    from .model.diagnostics import runtime_diags
    from .model.driver import Model
    scratch = tempfile.mkdtemp(prefix="sensitivity_")
    common = list(sets) + [
        'setup.dumpfreq="x"', f"setup.restart_dir={scratch}/",
        f"setup.history_dir={scratch}/",
        f"setup.pointer_file={scratch}/ptr"]
    cfg = lambda extra: cli.build_config(argparse.Namespace(
        opts=opts, set=common + extra))
    models = {"base": Model(cfg(["dtype=float64"]), device=device),
              "pert": Model(cfg(["dtype=float64"]), device=device),
              "f32": Model(cfg([]), device=device)}
    p = models["pert"]
    p.state = p.state.replace(vicen=p.state.vicen * (1.0 + 1e-15))
    out = []
    for step in range(1, steps + 1):
        for m in models.values():
            m.step()
        base = models["base"].state
        rec = {"step": step}
        for k in LEAVES:
            ref = getattr(base, k)
            scale = float(ref.abs().max()) or 1.0
            rec[k] = {name: _rel(getattr(models[name].state, k), ref, scale)
                      for name in ("pert", "f32")}
        for name, m in models.items():
            d = runtime_diags(m.grid, m.state)
            rec[f"hmax_{name}"] = float(d["hmax"])
            rec[f"umax_{name}"] = float(d["umax"])
        out.append(rec)
        print(f"step {step}: " + "; ".join(
            f"{k} pert {rec[k]['pert'][0]:.1e} (fold {rec[k]['pert'][1]:.1e})"
            f" f32 {rec[k]['f32'][0]:.1e} (fold {rec[k]['f32'][1]:.1e})"
            for k in LEAVES) + "; hmax " + " / ".join(
            f"{rec[f'hmax_{n}']:.6f}" for n in models) + "; umax " +
            " / ".join(f"{rec[f'umax_{n}']:.6f}" for n in models),
            flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--opts", default="tx1pop")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    recs = run(a.opts, a.steps, a.device, a.set)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(recs, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
