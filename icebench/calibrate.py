#!/usr/bin/env python3
"""The readings the correctness limits are set from, on a card, in one
process (the kernels load once):

    python3 icebench/calibrate.py --workload <cell> --seeds 1,2,3
        [--control-seeds 4,5,6] [--window-steps 24]

For each seed of `--seeds` the program runs the cell as a benchmark run
does, with a window of `--window-steps` steps in place of a timed one, and
prints its numbers compared; for each of `--control-seeds` the control
(`control.py`: the reference in the program's place, its state kept in
bfloat16) runs the same way. One JSON line per run on standard output.
The benchmark's own runs never run the control."""

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from icebench import catalog, harness  # noqa: E402
from icebench.control import control  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--window-steps", type=int, default=24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    bench = catalog.benchmark()
    dev = torch.device("cuda", 0)
    log = lambda s: print(f"calibrate: {s}", file=sys.stderr, flush=True)
    config = catalog.config(catalog.workload(bench, args.workload)["config"])
    runs = [(int(s), "program", None) for s in args.seeds.split(",") if s]
    runs += [(int(s), "control", control(config))
             for s in args.control_seeds.split(",") if s]
    for seed, side, system in runs:
        out = harness.run_cell(bench, args.workload, seed, 0, False, dev,
                               system=system, log=log,
                               window_steps=args.window_steps)
        row = {"workload": args.workload, "side": side, "seed": seed,
               "steps": out["n"]}
        row.update({k: {"value": v, "leaf": leaf}
                    for k, (v, leaf) in out["checks"].items()})
        print(json.dumps(row), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
