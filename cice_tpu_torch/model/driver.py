"""Model driver (PyTorch port of cice_tpu/model/driver.py; reference
CICE_InitMod.F90 `cice_init`, ice_init.F90 `set_state_var`:3266, the loop
body of CICE_RunMod.F90 `ice_step`).

`Model` owns config, grid, static tables, the open forcing datasets
(`datasets`), forcing, the calendar and the prognostic state on one
device. `step()` / `run(n)` advance the full coupled step (`model_step`)
with the calendar, prescribed ice before the step and boundary and SST
restoring after it, history accumulation and output, the diagnostics (the
point probes among them) and aborts at `diagfreq` (each abort writes an
early checkpoint first), the `debug_model` column dumps and restart dumps
at `dumpfreq`, through the background writer with `setup.io_async`;
`runtype='continue'` resumes from the pointer file. A coupler hands
`step(forcing=...)` its own Forcing (`model.coupling.CoupledIce`).
`run_dynamics(n)` advances only the dynamics-transport-ridging supercycle
(`step_dyn_transport`) under the data wind stress.

Across ranks (`mesh=`, a parallel.mesh.Mesh over an initialised process
group) every rank holds the whole state and steps it; the EVP solve of
`evp_algorithm='wide_halo'` is split into the ranks' tiles
(parallel/evp_wide.py), and a 'pio' restart is written tile by tile
(io/pio.py). Without a mesh 'wide_halo' runs the one-program solve, as
the JAX package does.

With `shard=True` (or `Model.shard()`, beside the JAX package's
`m.state = shard_state(mesh, m.state)`) each rank holds and steps only its
tile of every (..., ny, nx) array: the model is built whole, then its
grid, state, forcing and the other per-cell arrays are tiled. Each step
makes the forcing of the tiles, accumulates history on them, and takes the
diagnostics' totals over the mesh; history files and restarts other than
'pio' are gathered and written by the mesh's first rank, the same bytes as
one process's. `gather_state()` gives the whole state on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants as cst
from ..calendar import Calendar, npt_to_steps
from ..columns import itd as itd_mod
from ..columns.mushy import enthalpy_mush
from ..columns.thermo_vertical import (bl99_salinity, enthalpy_ice,
                                       enthalpy_snow, melting_temps)
from ..core.grid import Grid, make_grid
from ..core.halo import TileBC, tile_mesh
from ..core.reductions import host_read, host_wait
from ..utils.timers import Timers, span
from .flux import zeros_forcing
from .forcing import default_ocn, get_forcing
from .state import State, zeros_state
from .step import ModelStatic, check_ported, model_step, step_dyn_transport


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

    qice = []
    for k in range(nilyr):
        zf = (k + 0.5) / nilyr
        Tlay = Tsfc0 * (1.0 - zf) + Tf * zf
        Tlay = torch.clamp(Tlay, max=float(Tmlt[k]) - 0.1)
        if cfg.thermo.ktherm == 2:
            qice.append(enthalpy_mush(Tlay, torch.full_like(
                Tlay, float(salin[k]))))
        else:
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
    # z-tracer companions: the mobile fraction starts fully mobile;
    # aerosols start clean
    for nm in list(trcrn):
        if nm.endswith("_mf"):
            _init_bgc(nm, 1.0)
        elif nm.startswith("zaero"):
            _init_bgc(nm, 0.0)
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
    equivalents); with `mesh`, one rank of a run across ranks, and with
    `shard=True` one rank holding its tiles of the state."""

    def __init__(self, cfg, grid: Optional[Grid] = None, device="cuda",
                 enable_history: bool = False, mesh=None,
                 shard: bool = False):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Model(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        s = cfg.setup
        check_ported(cfg)
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
        self.mesh = mesh
        self.grid = grid if grid is not None else make_grid(cfg, device)
        self.static = ModelStatic.build(cfg, mesh=mesh)
        # the open forcing datasets, by stream (get_forcing's `datasets`)
        self.datasets: dict = {}
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
        self.io_writer = None
        if s.io_async:
            from ..io.async_writer import AsyncWriter
            self.io_writer = AsyncWriter(s.io_nthreads)
        self.history = None
        if enable_history:
            from ..io.history import History
            self.history = History(cfg, self.grid, writer=self.io_writer)
        # prescribed ice: the ice_cov dataset, uploaded once
        self._ice_cov = None
        if s.prescribed_ice:
            from .prescribed import load_ice_cov
            cov = load_ice_cov(cfg)
            if cov is not None:
                self._ice_cov = torch.as_tensor(cov, device=device)
        # boundary restoring: the target is the run's initial state (or
        # forcing.ice_data_file), captured here as ice_HaloRestore_init does
        self._restore_target = self._restore_zone = None
        if cfg.forcing.restore_ice:
            from .restoring import boundary_zone_weight, make_restore_target
            self._restore_target = make_restore_target(cfg, self.state)
            self._restore_zone = boundary_zone_weight(self.grid)
        # the probe cells of print_points and debug_model, found once
        self.points = None
        if s.print_points or s.debug_model:
            from .diagnostics import probe_points
            self.points = probe_points(self.grid, s.latpnt, s.lonpnt)
        self.dyn_diags: dict = {}
        self.tchecks: dict = {}
        self.diag_log: list = []
        #: the whole grid of a sharded model (self.grid is its tile)
        self.whole_grid = self.grid
        if shard:
            self.shard()

    # -- the state sharded across the ranks ----------------------------------
    @property
    def sharded(self) -> bool:
        return isinstance(self.grid.bc, TileBC)

    def shard(self) -> "Model":
        """Keep only this rank's tile of every (..., ny, nx) array of the
        model (grid, state, forcing, the last fluxes, the prescribed ice,
        the restoring target and zone, the history accumulators) and step
        those from now on."""
        if self.mesh is None:
            raise ValueError("Model.shard needs a mesh (parallel.mesh.Mesh)")
        if self.sharded:
            return self
        mesh, shape = self.mesh, self.grid.global_shape
        cut = lambda tree: mesh.shard_state(tree, shape)
        self.grid = mesh.tile_grid(self.whole_grid)
        self.state = cut(self.state)
        self.forcing = cut(self.forcing)
        self.flux = cut(self.flux)
        self._ice_cov = cut(self._ice_cov)
        self._restore_target = cut(self._restore_target)
        self._restore_zone = cut(self._restore_zone)
        if self.history is not None:
            hist = self.history
            from ..io.history import History
            self.history = History(self.cfg, self.grid, directory=hist.dir,
                                   writer=self.io_writer,
                                   whole_grid=self.whole_grid)
            for new, old in zip(self.history.streams, hist.streams):
                new.acc, new.last, new.nacc = cut(old.acc), cut(old.last), \
                    old.nacc
        return self

    def gather_state(self) -> State:
        """The whole state on every rank (the state itself unless
        sharded)."""
        if not self.sharded:
            return self.state
        return self.mesh.gather_state(self.state, self.grid.global_shape)

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
                           sec_of_year=(cal.fyday - 1.0) * cst.secday,
                           datasets=self.datasets)

    def step(self, timer=None, forcing=None) -> State:
        """One full coupled step: forcing (the model's own, or `forcing` as
        given), prescribed ice, `model_step`, boundary and SST restoring,
        the calendar and the yearly onset reset, history accumulation and
        output, every `diagfreq` steps the diagnostics (with the point
        probes) and the freshwater-budget, non-finite-state and
        transport-check aborts, the `debug_model` dump and the restart dump
        at `dumpfreq`. `timer` is handed to `model_step`."""
        cfg = self.cfg
        s = cfg.setup
        dt = s.dt
        self.timers.start("Total")
        state_pre = self.state
        with self.timers("Forcing"):
            self.forcing = self._forcing() if forcing is None else forcing
        fc = self.forcing
        if s.prescribed_ice:
            # AMIP-style prescribed concentration (ice_prescribed_mod): the
            # ITD is reset to the data before the (thermodynamic) step
            from .prescribed import prescribe_ice_state, prescribed_aice
            self.state = prescribe_ice_state(
                cfg, self.grid, self.state,
                prescribed_aice(self.grid, self.calendar, self._ice_cov),
                self.static.hin_max)
        with self.timers("TimeLoop"):
            self.state, self.flux = model_step(self.static, self.grid,
                                               self.state, fc, dt,
                                               timer=timer)
            if cfg.forcing.restore_ice:
                from .restoring import restore_ice
                self.state = restore_ice(cfg, self.grid, self.state,
                                         self._restore_target, dt,
                                         zone=self._restore_zone)
            if cfg.forcing.restore_ocn:
                from .restoring import restore_sst
                self.state = restore_sst(cfg, self.state, fc.sst_data, dt)
            host_wait("step_end", self.device)
        self.tchecks = self.flux.transport_checks
        prev_year = self.calendar.year
        self.calendar = self.calendar.advance(dt)
        if self.calendar.year != prev_year:
            # yearly reset of melt/freeze onset diagnostics (reference
            # resets mlt_onset/frz_onset with the annual history cycle)
            z = torch.zeros_like(self.state.mlt_onset)
            self.state = self.state.replace(mlt_onset=z, frz_onset=z)

        # analysis / IO phases (reference ice_step tail, CICE_RunMod:375-420)
        with self.timers("History"):
            if self.history is not None:
                with span("ice:history_accum"):
                    self.history.accum(self.state, self.flux, self.forcing)
                with span("ice:history_write"):
                    self.history.maybe_write(self.calendar,
                                             fmt=cfg.setup.history_format)
            if s.diagfreq and self.calendar.istep % s.diagfreq == 0:
                with span("ice:diagnostics"):
                    rec = self._diagnose(state_pre)
                    if s.print_points:
                        from .diagnostics import print_points_state
                        rec["points"] = print_points_state(
                            self.whole_grid, self.gather_state(),
                            points=self.points)
                self.diag_log.append(rec)
            if s.debug_model and self.calendar.istep >= s.debug_model_step:
                with span("ice:diagnostics"):
                    self._debug_dump()
            if self.calendar.is_boundary(s.dumpfreq, s.dumpfreq_n, dt):
                with span("ice:restart"):
                    self.write_restart()
        self.timers.stop("Total")
        return self.state

    def _debug_dump(self):
        """Print the full column at the debug point (debug_model_i/j, or
        the first probe point where they are negative)."""
        from .diagnostics import debug_ice
        s = self.cfg.setup
        i, j = s.debug_model_i, s.debug_model_j
        if i < 0 or j < 0:
            i, j = self.points[0]["i"], self.points[0]["j"]
        print(f"debug_model step {self.calendar.istep}:",
              debug_ice(self.whole_grid, self.gather_state(), j, i,
                        stage="post_step"))

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
        rec = {k: host_read("diag", v)
               for k, v in runtime_diags(self.grid, self.state).items()}
        if not cfg.setup.conserv_check:
            return rec
        rec["total_energy"] = host_read("diag",
                                        total_energy(self.grid, self.state))
        rec["total_water"] = host_read("diag", total_water_mass(self.grid,
                                                                self.state))
        bud = hemispheric_budgets(
            self.grid, state_pre, self.state, self.flux, self.forcing,
            cfg.setup.dt, frazil_in_fresh=cfg.forcing.update_ocn_f,
            pond_lvl=cfg.tracers.tr_pond_lvl)
        rec.update({f"bud_{k}": host_read("diag", v) for k, v in bud.items()})
        # the water budget closes to ~5e-4 relative (a small snow-ice
        # bookkeeping term); 1% catches any genuinely lost budget term.
        # Prescribed ice and restoring change mass with no flux term, so
        # the residual means nothing there and the abort is off (the
        # reference skips conservation aborts for prescribed runs too)
        wscale = max(abs(rec["bud_dM"]), abs(rec["bud_water_in"]), 1.0)
        nudged = (cfg.setup.prescribed_ice or cfg.forcing.restore_ice or
                  cfg.forcing.restore_ocn)
        if not nudged and abs(rec["bud_water_residual"]) > 1e-2 * wscale:
            self._abort(RuntimeError(
                f"freshwater budget closure violated at step {istep}: "
                f"residual {rec['bud_water_residual']:.3e} kg vs budget "
                f"{wscale:.3e} kg (early checkpoint written)"))
        if host_read("diag", check_state(
                self.state, mesh=tile_mesh(self.grid.bc))["nonfinite"]):
            self._abort(FloatingPointError(
                f"non-finite state at step {istep} (early checkpoint "
                "written)"))
        tc = self.flux.transport_checks
        if tc:
            tol = 1e-9 if self.state.aicen.dtype == torch.float64 else 1e-4
            cons = max(host_read("diag", tc.get("cons_err_area", 0.0)),
                       host_read("diag", tc.get("cons_err_tracer", 0.0)))
            rec["transport_cons_err"] = cons
            bad = [msg for key, msg in (
                ("oob", "departure points out of bounds"),
                ("neg_mass", "negative mass after remap"),
                ("mono_violation", "tracer monotonicity violation"))
                if host_read("diag", tc.get(key, False))]
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
                             fmt=s.restart_format, writer=self.io_writer,
                             mesh=self.mesh,
                             tiles_of=(self.grid.global_shape if self.sharded
                                       else None))

    def flush_io(self) -> int:
        """Durability barrier of the background writer (nothing to wait for
        without `setup.io_async`): returns when every queued file is on
        disk; raises IOError if any write failed."""
        if self.io_writer is None:
            return 0
        errs = self.io_writer.flush()
        if errs:
            raise IOError(f"{errs} background history/restart writes "
                          "failed")
        return errs

    def run(self, nsteps: Optional[int] = None, timer=None) -> State:
        """Advance `nsteps` full coupled steps (default: the run length
        `setup.npt` in `setup.npt_unit`), then write the final restart if
        `setup.dump_last`, and flush the writer."""
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
