"""The reference model of the configurations that name the reference
"gx1bgcz": the `ice` reference's `ReferenceModel`, with this directory's
tracer registry, initial z tracers, file forcing and step (brine height
and z tracers in therm1), stepped in the precision it is given.

A step is what the program's `Model.step` does to the prognostic state in
these configurations: the NCAR and ocean-climatology forcing at the
calendar's instant, `model_step`, the calendar's advance and the yearly
reset of the onset diagnostics. History, diagnostics and files change no
state and are left out.
"""

from __future__ import annotations

import torch

from ..ice import constants as cst
from ..ice.config import Config
from ..ice.core.grid import make_grid
from ..ice.reference import ReferenceModel as IceReferenceModel
from .forcing import get_forcing, initial_forcing, open_datasets
from .initial import set_state_var
from .state import zeros_state
from .step import ModelStatic, model_step


class ReferenceModel(IceReferenceModel):
    """The frozen plain path with the z tracers on `device` in `dtype`
    ('float64' or 'float32'), configured by the same overrides as the
    program."""

    def __init__(self, run: dict, device, dtype: str = "float64"):
        # the plain path's float32 matmuls (the porosity interpolation)
        # in full float32, as the program computes them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg = Config().with_overrides(**{**run, "dtype": dtype})
        self.device = torch.device(device)
        self.static = ModelStatic.build(cfg)
        self.grid = make_grid(cfg, self.device)
        self.forcing0 = initial_forcing(cfg, self.grid)
        self.datasets = open_datasets(cfg, self.device)

    def zeros(self):
        """A state of zeros of this model's shapes, dtype and device."""
        return zeros_state(self.cfg, self.grid)

    def default_state(self):
        """CICE's default initial state (`set_state_var`) on this grid,
        with the brine height and the z tracers."""
        return set_state_var(self.cfg, self.grid, self.zeros(),
                             self.forcing0.Tf)

    def step(self, state, cal):
        """(state, calendar) after one coupled step from `state` at `cal`."""
        dt = self.cfg.setup.dt
        fc = get_forcing(self.cfg, self.grid, self.datasets, cal.year,
                         (cal.fyday - 1.0) * cst.secday, cal.fyday,
                         self.forcing0)
        state, _ = model_step(self.static, self.grid, state, fc, dt)
        new = cal.advance(dt)
        if new.year != cal.year:
            z = torch.zeros_like(state.mlt_onset)
            state = state.replace(mlt_onset=z, frz_onset=z)
        return state, new
