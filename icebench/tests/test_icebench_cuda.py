"""On a card: one short run of each cell through the command, its last
line, and the exit without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from icebench import catalog

RUN = [sys.executable, os.path.join(catalog.HERE, "run.py")]


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(RUN + ["--workload", "om025.hourly", "--seed", "1",
                                "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=catalog.REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(RUN + ["--workload", "om025.hourly", "--seed", "12",
                                "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=catalog.REPO,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
