"""The system under test: the program's `Model`, built from the cell's
configuration, handed the benchmark's initial state, and stepped by
`Model.step`. This is the only module of the benchmark that imports the
program."""

from __future__ import annotations

from .leaves import fill, leaves


class Program:
    def __init__(self, run: dict, device, history: bool, initial: dict):
        from cice_tpu_torch.config import Config
        from cice_tpu_torch.model.driver import Model
        cfg = Config().with_overrides(**run)
        self.model = Model(cfg, device=device, enable_history=history)
        self.model.state = fill(self.model.state, initial)

    def step(self, timer=None):
        self.model.step(timer=timer)

    def leaves(self) -> dict:
        return leaves(self.model.state)

    def load(self, named: dict):
        """Put `named` in the program's state (the fault tests' hook)."""
        self.model.state = fill(self.model.state, named)

    def host_seconds(self) -> dict:
        """Seconds so far on the program's own host timers."""
        t = self.model.timers
        return {k: t.get(k) for k in ("Forcing", "History")}

    def close(self):
        self.model.flush_io()
        for ds in self.model.datasets.values():
            ds.close()
        self.model = None
