"""The reference model of the configurations that name the reference
"ice": this frozen plain path stepped from the same inputs as the
program, in the precision it is given.

It builds its own grid from the grid files, its own static tables, forcing
and calendar, and steps with the plain engines (the EVP's plain loop, the
plain exact remap); it refuses a configuration that needs an engine it
does not carry (`model.step.check_supported`). A step is what the
program's `Model.step` does to the prognostic state in these
configurations: the forcing at the calendar's instant, `model_step`, the
calendar's advance and the yearly reset of the onset diagnostics.
History, diagnostics and files change no state and are left out.

`ReferenceModel` keeps the contract that `icebench.catalog.reference`
states; a reference of another directory may subclass it and import these
frozen modules, adding only its own engines and its own `SUPPORTED`.
"""

from __future__ import annotations

import torch

from .calendar import Calendar
from .config import Config
from .core.grid import make_grid
from .dynamics.remap_exact import build_flat_table
from .model.flux import zeros_forcing
from .model.forcing import default_ocn, get_forcing
from .model.initial import set_state_var
from .model.state import State, zeros_state
from .model.step import ModelStatic, model_step


class ReferenceModel:
    """The frozen plain path on `device` in `dtype` ('float64' or
    'float32'), configured by the same overrides as the program."""

    def __init__(self, run: dict, device, dtype: str = "float64"):
        self.cfg = cfg = Config().with_overrides(**{**run, "dtype": dtype})
        self.device = torch.device(device)
        self.grid = make_grid(cfg, self.device)
        self.static = ModelStatic.build(cfg)
        fc = zeros_forcing(self.grid.shape, cfg.np_dtype, self.device)
        self.forcing0 = default_ocn(self.grid, cfg, fc)

    def zeros(self) -> State:
        """A state of zeros of this model's shapes, dtype and device."""
        return zeros_state(self.cfg, self.grid)

    def default_state(self) -> State:
        """CICE's default initial state (`set_state_var`) on this grid."""
        return set_state_var(self.cfg, self.grid, self.zeros(),
                             self.forcing0.Tf)

    def tracer_count(self) -> int:
        """NT: the number of tracers that the transport carries."""
        return len(build_flat_table(self.static.registry))

    def calendar(self, nsteps: int = 0) -> Calendar:
        """The calendar after `nsteps` steps from the configured start."""
        s = self.cfg.setup
        cal_type = s.calendar_type
        if s.use_leap_years and cal_type == "noleap":
            cal_type = "gregorian"
        cal = Calendar(calendar_type=cal_type, year=s.year_init,
                       month=s.month_init, day=s.day_init, sec=s.sec_init,
                       year_init=s.year_init)
        for _ in range(nsteps):
            cal = cal.advance(s.dt)
        return cal

    def step(self, state: State, cal: Calendar):
        """(state, calendar) after one coupled step from `state` at `cal`."""
        dt = self.cfg.setup.dt
        fc = get_forcing(self.cfg, self.grid, float(cal.elapsed_seconds),
                         cal.fyday, state.aice, self.forcing0)
        state, _ = model_step(self.static, self.grid, state, fc, dt)
        new = cal.advance(dt)
        if new.year != cal.year:
            z = torch.zeros_like(state.mlt_onset)
            state = state.replace(mlt_onset=z, frz_onset=z)
        return state, new
