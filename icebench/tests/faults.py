"""Faults planted under the timed path, for the test that the comparison
catches them: each wraps a system (the program, or the control) and
breaks what its step produces."""

from __future__ import annotations

import torch

#: the faults a cell of one chip can have: a step that returns its state
#: unchanged; half of the grid left unstepped; one field of the answer
#: altered where it is produced
KINDS = ("unchanged", "half_grid", "altered")


class Faulty:
    def __init__(self, inner, kind: str):
        if kind not in KINDS:
            raise ValueError(kind)
        self.inner, self.kind = inner, kind

    def step(self, timer=None):
        before = {k: v.clone() for k, v in self.inner.leaves().items()}
        self.inner.step(timer)
        if self.kind == "unchanged":
            self.inner.load(before)
        elif self.kind == "half_grid":
            after = self.inner.leaves()
            mixed = {}
            for k, v in after.items():
                ny = v.shape[-2]
                w = v.clone()
                w[..., : ny // 2, :] = before[k][..., : ny // 2, :]
                mixed[k] = w
            self.inner.load(mixed)
        else:
            after = dict(self.inner.leaves())
            after["vicen"] = after["vicen"] * (1.0 + 1e-3)
            self.inner.load(after)

    def leaves(self) -> dict:
        return self.inner.leaves()

    def load(self, named: dict):
        self.inner.load(named)

    def host_seconds(self) -> dict:
        return self.inner.host_seconds()

    def close(self):
        self.inner.close()
