"""The control of the comparison: the reference put in the program's
place, its state kept in bfloat16, the precision below the
configuration's float32 that would tempt a change (half the bytes of
every state read). Each step rounds the state to bfloat16 and computes in
float32. The benchmark's own runs never run it; `calibrate.py` and the
tests do, and the comparison has to call it not correct."""

from __future__ import annotations

import functools

import torch

from . import catalog
from .leaves import fill, leaves


class Bfloat16State:
    """The system of a control run, on `reference`, a `ReferenceModel`
    class; `control` binds the one of a configuration."""

    def __init__(self, reference, run: dict, device, history: bool,
                 initial: dict):
        self.ref = reference(run, device, "float32")
        self.state = fill(self.ref.zeros(), initial)
        self.cal = self.ref.calendar(0)

    def step(self, timer=None):
        named = {k: (v.to(torch.bfloat16) if v.is_floating_point() else v)
                 for k, v in leaves(self.state).items()}
        self.state, self.cal = self.ref.step(fill(self.state, named),
                                             self.cal)

    def leaves(self) -> dict:
        return leaves(self.state)

    def host_seconds(self) -> dict:
        return {}

    def close(self):
        self.ref = None


def control(config: dict):
    """The control's system for `config`, built as `run_cell` builds the
    program: (run, device, history, initial)."""
    return functools.partial(Bfloat16State, catalog.reference(config))
