#!/usr/bin/env python3
"""The benchmark's command:

    python3 icebench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

run from the root of a checkout. It prints, as its last line, one JSON
object: correct, attempted, failed, metrics, device (and, traced, the
breakdown), then the checks. See harness.py."""

import os
import sys

os.environ.setdefault("OMP_NUM_THREADS", "4")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from icebench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
