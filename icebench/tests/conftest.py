"""The benchmark's own tests run on the CPU, at small grids; those marked
`cuda` run on a card and skip without one."""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)
torch.set_num_threads(2)


@pytest.fixture(scope="session")
def bench():
    from icebench import catalog
    return catalog.benchmark()
