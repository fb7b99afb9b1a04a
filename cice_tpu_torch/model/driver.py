"""Model driver (PyTorch port of cice_tpu/model/driver.py; reference
CICE_InitMod.F90 `cice_init`, ice_init.F90 `set_state_var`:3266, the loop
body of CICE_RunMod.F90 `ice_step`).

`Model` owns config, grid, static tables, forcing, the calendar and the
prognostic state on one device. `step()` / `run(n)` advance the full
coupled step (`model_step`) with the calendar, history accumulation and
output, the diagnostics and aborts at `diagfreq` (each abort writes an
early checkpoint first) and restart dumps at `dumpfreq`; `runtype=
'continue'` resumes from the pointer file. `run_dynamics(n)` advances only
the dynamics-transport-ridging supercycle (`step_dyn_transport`) under the
data wind stress. Prescribed ice, restoring, point probes, the background
writer (ROADMAP A7) and sharded restarts (A8) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants as cst
from ..calendar import Calendar, npt_to_steps
from ..columns import itd as itd_mod
from ..columns.thermo_vertical import (bl99_salinity, enthalpy_ice,
                                       enthalpy_snow, melting_temps)
from ..core.grid import Grid, make_grid
from ..utils.timers import Timers
from .flux import zeros_forcing
from .forcing import default_ocn, get_forcing
from .state import State, zeros_state
from .step import ModelStatic, model_step, step_dyn_transport


def _scalar(v, dtype, device) -> torch.Tensor:
    """0-d tensor of v in `dtype` (a bare Python float in torch.where
    would round through the default float32)."""
    return torch.tensor(float(v), dtype=dtype, device=device)


def set_state_var(cfg, grid: Grid, state: State, Tf) -> State:
    """Initial ice distribution (reference set_state_var, ice_ic='default'):
    ice poleward of 60 degrees over ocean, parabolic ITD, linear
    temperature profile between Tsfc and Tf."""
    ncat = cfg.domain.ncat
    nilyr, nslyr = cfg.domain.nilyr, cfg.domain.nslyr
    dtp = state.aicen.dtype
    dev = state.aicen.device
    hin_max = itd_mod.category_bounds(ncat, cfg.grid.kcatbound, nilyr,
                                      cfg.thermo.kitd)
    ainit, hinit = itd_mod.initial_itd_profile(ncat, hin_max)

    lat = grid.TLAT.detach().cpu().numpy() * cst.rad_to_deg
    tmask = grid.tmask.cpu().numpy()
    icemask = torch.as_tensor(tmask & ((lat > 60.0) | (lat < -60.0)),
                              device=dev)

    salin = bl99_salinity(nilyr)
    Tmlt = melting_temps(salin)

    aicen, vicen, vsnon = [], [], []
    Tsfc0 = torch.where(icemask, -5.0, 0.0).to(dtp)
    trcrn = dict(state.trcrn)
    for n in range(ncat):
        a = torch.where(icemask, _scalar(ainit[n], dtp, dev), 0.0)
        aicen.append(a)
        vicen.append(a * float(hinit[n]))
        vsnon.append(a * float(min(0.2, 0.2 * hinit[n])))
    aicen = torch.stack(aicen)
    vicen = torch.stack(vicen)
    vsnon = torch.stack(vsnon)

    if cfg.thermo.ktherm == 2:
        raise NotImplementedError(
            "mushy (ktherm=2) initial enthalpy is not ported yet (ROADMAP "
            "A6: column options)")
    qice = []
    for k in range(nilyr):
        zf = (k + 0.5) / nilyr
        Tlay = Tsfc0 * (1.0 - zf) + Tf * zf
        Tlay = torch.clamp(Tlay, max=float(Tmlt[k]) - 0.1)
        qice.append(enthalpy_ice(Tlay, float(Tmlt[k])))
    qice = torch.stack(qice)                     # (nilyr, ny, nx)
    qsno = enthalpy_snow(torch.clamp(Tsfc0, max=-1.0))

    shp = grid.shape
    trcrn["Tsfcn"] = Tsfc0.expand((ncat,) + shp).to(dtp).clone()
    trcrn["qice"] = qice[None].expand((ncat, nilyr) + shp).to(dtp).clone()
    trcrn["qsno"] = qsno[None, None].expand((ncat, nslyr) + shp).to(
        dtp).clone()
    trcrn["sice"] = torch.as_tensor(salin, dtype=dtp, device=dev)[
        None, :, None, None].expand((ncat, nilyr) + shp).clone()
    if "alvl" in trcrn:
        trcrn["alvl"] = torch.where(aicen > 0, 1.0, 0.0).to(dtp)
        trcrn["vlvl"] = torch.where(vicen > 0, 1.0, 0.0).to(dtp)
    if "FY" in trcrn:
        trcrn["FY"] = torch.where(aicen > 0, 1.0, 0.0).to(dtp)
    if "fsd" in trcrn:
        f = torch.zeros_like(trcrn["fsd"])
        f[:, 0] = 1.0
        trcrn["fsd"] = f

    def _init_bgc(nm, v0):
        if nm not in trcrn:
            return
        m = aicen > 0
        if trcrn[nm].ndim == 4:
            m = m[:, None]
        trcrn[nm] = torch.where(m, _scalar(v0, dtp, dev), 0.0).expand_as(
            trcrn[nm]).clone()

    if "bgc_Nit" in trcrn:
        _init_bgc("bgc_Nit", cfg.zbgc.nit_data)
        _init_bgc("bgc_N", 0.5)
    for nm, v0 in (("bgc_N2", 0.3), ("bgc_N3", 0.2),
                   ("bgc_Am", cfg.zbgc.amm_data),
                   ("bgc_Sil", cfg.zbgc.sil_data),
                   ("bgc_DMSPp", 0.1), ("bgc_DMSPd", cfg.zbgc.dms_data),
                   ("bgc_DMS", cfg.zbgc.dms_data), ("bgc_PON", 0.1),
                   ("bgc_DON", 1.0), ("bgc_Fed", cfg.zbgc.fed_data),
                   ("bgc_Fep", 0.1), ("bgc_hum", cfg.zbgc.hum_data),
                   ("bgc_DOC1", cfg.zbgc.doc_data),
                   ("bgc_DOC2", cfg.zbgc.doc_data),
                   ("bgc_DOC3", cfg.zbgc.doc_data),
                   ("bgc_DIC1", cfg.zbgc.dic_data)):
        _init_bgc(nm, v0)
    if "fbri" in trcrn:
        trcrn["fbri"] = torch.where(aicen > 0, 1.0, 0.0).to(dtp)
    if "rsnw" in trcrn:
        trcrn["rsnw"] = torch.full_like(trcrn["rsnw"], cfg.snow.rsnw_fall)
        trcrn["smice"] = torch.where(
            vsnon[:, None] > 0,
            cst.rhos * vsnon[:, None] / torch.clamp(aicen[:, None], min=1e-6)
            / cfg.domain.nslyr, 0.0).to(dtp)

    sst = torch.where(icemask, Tf, torch.clamp(Tf, min=-1.0)).to(dtp)
    return state.replace(aicen=aicen, vicen=vicen, vsnon=vsnon, trcrn=trcrn,
                         sst=sst)


class Model:
    """Standalone model instance on one device (cice_init + CICE_Run
    equivalents)."""

    def __init__(self, cfg, grid: Optional[Grid] = None, device="cuda",
                 enable_history: bool = False):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Model(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        s = cfg.setup
        if s.restart_format == "pio":
            raise NotImplementedError(
                "restart_format='pio' (sharded restarts) is not ported yet "
                "(ROADMAP A8: multi-GPU)")
        if s.io_async:
            raise NotImplementedError(
                "the background history/restart writer (setup.io_async) is "
                "not ported yet (ROADMAP A7: forcing files, coupling and "
                "I/O)")
        if s.prescribed_ice or cfg.forcing.restore_ice or \
                cfg.forcing.restore_ocn:
            raise NotImplementedError(
                "prescribed ice and restoring are not ported yet (ROADMAP "
                "A7)")
        if s.print_points or s.debug_model:
            raise NotImplementedError(
                "print_points and debug_model probes are not ported yet "
                "(ROADMAP A7)")
        # use_leap_years / days_per_year resolve to the calendar type
        # (reference ice_calendar init_calendar consistency checks)
        cal_type = s.calendar_type
        if s.use_leap_years and cal_type == "noleap":
            cal_type = "gregorian"
        expected = {"noleap": 365, "gregorian": 365, "360day": 360}[cal_type]
        if s.days_per_year != expected:
            raise ValueError(
                f"days_per_year={s.days_per_year} inconsistent with "
                f"calendar_type='{cal_type}' (expected {expected})")
        self.calendar = Calendar(
            calendar_type=cal_type, year=s.year_init, month=s.month_init,
            day=s.day_init, sec=s.sec_init, year_init=s.year_init)
        self.cfg = cfg
        self.device = device
        self.grid = grid if grid is not None else make_grid(cfg, device)
        self.static = ModelStatic.build(cfg)
        self.forcing = zeros_forcing(self.grid.shape, cfg.np_dtype, device)
        if cfg.forcing.default_season == "summer":
            warm = torch.full(self.grid.shape, 273.15 + 2.0,
                              dtype=cfg.np_dtype, device=device)
            self.forcing = self.forcing.replace(Tair=warm, potT=warm)
        self.forcing = default_ocn(self.grid, cfg, self.forcing)
        self.state = zeros_state(cfg, self.grid)
        if s.runtype == "continue":
            from ..io.restart import read_restart
            self.state, self.calendar = read_restart(s.pointer_file,
                                                     self.state)
        elif s.ice_ic == "default":
            self.state = set_state_var(cfg, self.grid, self.state,
                                       self.forcing.Tf)
        self.timers = Timers().init_standard()
        self.flux = None
        self.io_writer = None       # the background writer waits for A7
        self.history = None
        if enable_history:
            from ..io.history import History
            self.history = History(cfg, self.grid)
        self.dyn_diags: dict = {}
        self.tchecks: dict = {}
        self.diag_log: list = []

    @property
    def istep(self) -> int:
        return self.calendar.istep

    @property
    def elapsed_seconds(self) -> int:
        return self.calendar.elapsed_seconds

    @property
    def yday(self) -> float:
        """Fractional day of the year (1-based)."""
        return self.calendar.fyday

    @property
    def year(self) -> int:
        return self.calendar.year

    def _forcing(self):
        """The forcing at the calendar's instant."""
        cal = self.calendar
        return get_forcing(self.cfg, self.grid, float(cal.elapsed_seconds),
                           cal.fyday, self.state.aice, self.forcing,
                           year=cal.year,
                           sec_of_year=(cal.fyday - 1.0) * cst.secday)

    def step(self, timer=None) -> State:
        """One full coupled step: forcing, `model_step`, the calendar and
        the yearly onset reset, history accumulation and output, every
        `diagfreq` steps the diagnostics with the freshwater-budget,
        non-finite-state and transport-check aborts, and the restart dump
        at `dumpfreq`. `timer` is handed to `model_step`."""
        cfg = self.cfg
        dt = cfg.setup.dt
        self.timers.start("Total")
        state_pre = self.state
        with self.timers("Forcing"):
            self.forcing = self._forcing()
        with self.timers("TimeLoop"):
            self.state, self.flux = model_step(self.static, self.grid,
                                               self.state, self.forcing, dt,
                                               timer=timer)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.tchecks = self.flux.transport_checks
        prev_year = self.calendar.year
        self.calendar = self.calendar.advance(dt)
        if self.calendar.year != prev_year:
            # yearly reset of melt/freeze onset diagnostics (reference
            # resets mlt_onset/frz_onset with the annual history cycle)
            z = torch.zeros_like(self.state.mlt_onset)
            self.state = self.state.replace(mlt_onset=z, frz_onset=z)

        # analysis / IO phases (reference ice_step tail, CICE_RunMod:375-420)
        self.timers.start("History")
        if self.history is not None:
            self.history.accum(self.state, self.flux, self.forcing)
            self.history.maybe_write(self.calendar,
                                     fmt=cfg.setup.history_format)
        if cfg.setup.diagfreq and \
                self.calendar.istep % cfg.setup.diagfreq == 0:
            self.diag_log.append(self._diagnose(state_pre))
        if self.calendar.is_boundary(cfg.setup.dumpfreq,
                                     cfg.setup.dumpfreq_n, dt):
            self.write_restart()
        self.timers.stop("History")
        self.timers.stop("Total")
        return self.state

    def _abort(self, exc: Exception):
        """Write an early checkpoint of the offending state, then raise."""
        self.write_restart()
        self.flush_io()
        raise exc

    def _diagnose(self, state_pre: State) -> dict:
        """The diagfreq record; on a violated conservation check it writes
        an early checkpoint and raises."""
        from .diagnostics import (check_state, hemispheric_budgets,
                                  runtime_diags, total_energy,
                                  total_water_mass)
        cfg = self.cfg
        istep = self.calendar.istep
        rec = {k: float(v)
               for k, v in runtime_diags(self.grid, self.state).items()}
        if not cfg.setup.conserv_check:
            return rec
        rec["total_energy"] = float(total_energy(self.grid, self.state))
        rec["total_water"] = float(total_water_mass(self.grid, self.state))
        bud = hemispheric_budgets(
            self.grid, state_pre, self.state, self.flux, self.forcing,
            cfg.setup.dt, frazil_in_fresh=cfg.forcing.update_ocn_f,
            pond_lvl=cfg.tracers.tr_pond_lvl)
        rec.update({f"bud_{k}": float(v) for k, v in bud.items()})
        # the water budget closes to ~5e-4 relative (a small snow-ice
        # bookkeeping term); 1% catches any genuinely lost budget term
        wscale = max(abs(rec["bud_dM"]), abs(rec["bud_water_in"]), 1.0)
        if abs(rec["bud_water_residual"]) > 1e-2 * wscale:
            self._abort(RuntimeError(
                f"freshwater budget closure violated at step {istep}: "
                f"residual {rec['bud_water_residual']:.3e} kg vs budget "
                f"{wscale:.3e} kg (early checkpoint written)"))
        if bool(check_state(self.state)["nonfinite"]):
            self._abort(FloatingPointError(
                f"non-finite state at step {istep} (early checkpoint "
                "written)"))
        tc = self.flux.transport_checks
        if tc:
            tol = 1e-9 if self.state.aicen.dtype == torch.float64 else 1e-4
            cons = max(float(tc.get("cons_err_area", 0.0)),
                       float(tc.get("cons_err_tracer", 0.0)))
            rec["transport_cons_err"] = cons
            bad = [msg for key, msg in (
                ("oob", "departure points out of bounds"),
                ("neg_mass", "negative mass after remap"),
                ("mono_violation", "tracer monotonicity violation"))
                if bool(tc.get(key, False))]
            if cons > tol:
                bad.append(f"global conservation error {cons:.3e}")
            if bad:
                self._abort(RuntimeError(
                    f"transport check failed at step {istep}: "
                    f"{'; '.join(bad)} (early checkpoint written)"))
        return rec

    def write_restart(self) -> str:
        """Dump the state and calendar (and update the pointer file)."""
        from ..io.restart import write_restart
        s = self.cfg.setup
        return write_restart(s.restart_dir, self.state, self.calendar,
                             s.pointer_file, prefix=s.restart_file,
                             fmt=s.restart_format)

    def flush_io(self) -> int:
        """Durability barrier for the background writer; every write of
        this port is synchronous (the writer waits for ROADMAP A7), so
        there is nothing to wait for."""
        return 0

    def run(self, nsteps: Optional[int] = None, timer=None) -> State:
        """Advance `nsteps` full coupled steps (default: the run length
        `setup.npt` in `setup.npt_unit`), then write the final restart if
        `setup.dump_last`."""
        s = self.cfg.setup
        n = nsteps if nsteps is not None else npt_to_steps(
            s.npt, s.npt_unit, s.dt, self.calendar)
        for _ in range(n):
            self.step(timer=timer)
        if s.dump_last:
            self.write_restart()
        self.flush_io()
        return self.state

    def run_dynamics(self, n: int = 1) -> State:
        """Advance n thermo steps of the dynamics-transport-ridging
        supercycle alone, under the data wind stress of the forcing
        (`strax`/`stray`), with the forcing and the calendar updated each
        step."""
        cfg = self.cfg
        dt = cfg.setup.dt
        for _ in range(n):
            fc = self._forcing()
            self.forcing = fc
            self.state, self.dyn_diags, self.tchecks = step_dyn_transport(
                self.static, self.grid, self.state, fc, fc.strax, fc.stray,
                dt)
            self.calendar = self.calendar.advance(dt)
        return self.state
