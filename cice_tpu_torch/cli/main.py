"""Command-line interface of the port (cice_tpu/cli/main.py's commands):
runs, case directories, single tests, suites, the EVP performance sweep,
the statistical QC comparison and plots.

    python -m cice_tpu_torch.cli run   [--opts a,b] [--set k=v ...] [--steps N]
        [--profile DIR]
    python -m cice_tpu_torch.cli case  --dir DIR [--opts a,b] [--set k=v ...]
    python -m cice_tpu_torch.cli test  --type smoke|restart|decomp|baseline \
        [--opts a,b] [--set k=v ...] [--bgen DIR] [--bcmp DIR]
    python -m cice_tpu_torch.cli suite --name quick [--set k=v ...]
    python -m cice_tpu_torch.cli perf  [--sizes 192x160,...] [--ndte 120]
        [--mesh 1,2,4,8]
    python -m cice_tpu_torch.cli qc DIR_A DIR_B [--var hi]
    python -m cice_tpu_torch.cli plot2d FILE... [-f aice]
    python -m cice_tpu_torch.cli timeseries DIAG.json [-k key]

`--device` defaults to `cuda`; `--device cpu` runs on the CPU. The option
sets and suites are the JAX package's tables (the reference's set_nml.*
fragments and tests/*.ts); "{FIX}" resolves to the port's fixture root
($CICE_TPU_TORCH_FIXTURES), where the gx3/gx1/tx1 baseline fixtures are
written on first use; `python -m cice_tpu_torch` is the same CLI. A row of a
suite that raises counts as failed and the suite goes on. A run of one
process has no mesh: `evpwide` then runs the one-program EVP solve and
`iopio` writes its restarts as one shard per array, as the JAX package
does on one device.

`test --type decomp` spawns 8 ranks joined by gloo (on the card they
share it) and runs 2 steps with the state sharded on 2x4 and on 4x2 ranks
against 2 steps of one process, in f64; `perf --mesh 1,2,4,8` times the
EVP on a sharded state over that many spawned ranks.

`run --profile DIR` traces the time loop with torch.profiler (CPU, and
CUDA where the model runs on the card) and writes a Chrome trace into
DIR, with the program's own ranges (utils/timers.py: the Timers, the
phases "ice:<phase>", the blocking reads "sync:<site>"). `run` prints
the process's blocking reads by site under "syncs" and its launches of
the hand-written kernels (K1-K4, K4 by route) under "launches".

`test --type baseline` runs the full length of an option set (gx3pop,
gx1pop, tx1pop) with history, archives {"final", "series", "timers"} as
`<label>.json` (in `--bgen DIR`, else `<fixture root>/baselines`) and, with
`--bcmp DIR`, compares the diagnostics series with `DIR/<label>.json` (the
repo's `baselines/rNN`) at rtol 1e-3, report-only. The JAX package reads
that directory from $CICE_TPU_BCMP_DIR and sends `--bcmp` to the series
flow of the smoke and restart tests, which looks for `baseline_<label>.json`
there; here `--bcmp` names the committed directory itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: option fragments (set_nml.* analogues), copied from cice_tpu/cli/main.py
OPTION_SETS = {
    "box2001": {"grid.nx_global": 80, "grid.ny_global": 80,
                "grid.grid_format": "rect", "grid.kmt_type": "none",
                "forcing.atm_data_type": "box2001",
                "forcing.ocn_data_type": "box2001"},
    "gridc": {"grid.grid_ice": "C"},
    "dynpicard": {"dynamics.kdyn": 3},
    "eap": {"dynamics.kdyn": 2},
    "upwind": {"dynamics.advection": "upwind"},
    "nodyn": {"dynamics.kdyn": 0},
    "ndte120": {"dynamics.ndte": 120},
    "debugthermo": {"thermo.nit": 30},
    "seasonal": {"forcing.atm_data_type": "seasonal"},
    # physics option fragments added with the full column-physics set
    "gridcd": {"grid.grid_ice": "CD"},
    "dynanderson": {"dynamics.kdyn": 3, "dynamics.algo_nonlin": "anderson"},
    "mushy": {"thermo.ktherm": 2, "thermo.tfrz_option": "mushy"},
    "bl99": {"thermo.ktherm": 1},
    "dedd": {"shortwave.shortwave": "dEdd"},
    "ccsm3sw": {"shortwave.shortwave": "ccsm3"},
    "snwgrain": {"tracers.tr_snow": True, "snow.snwgrain": True,
                 "snow.snwredist": "bulk"},
    "fsd12": {"tracers.tr_fsd": True, "domain.nfsd": 12,
              "forcing.wave_spec_type": "profile"},
    "pondtopo": {"tracers.tr_pond_lvl": False, "tracers.tr_pond_topo": True},
    "pondsealvl": {"tracers.tr_pond_lvl": False,
                   "tracers.tr_pond_topo": False,
                   "tracers.tr_pond_sealvl": True,
                   "ponds.apnd_sl": 0.27, "ponds.rfracmin": 1.0,
                   "ponds.rfracmax": 1.0, "ponds.tscale_pnd_drain": 0.5},
    "saltflux": {"thermo.ktherm": 2, "thermo.saltflux_option": "prognostic"},
    "modal": {"shortwave.shortwave": "dEdd", "tracers.tr_aero": True,
              "domain.n_aero": 3, "shortwave.modal_aero": True},
    "congel": {"thermo.congel_freeze": "one-step"},
    "pondlvl": {"tracers.tr_pond_lvl": True, "tracers.tr_pond_topo": False},
    "bgcskl": {"zbgc.skl_bgc": True},
    # vertically-resolved z-tracer BGC on the brine column (set_nml.bgcz)
    "bgcz": {"zbgc.z_tracers": True, "zbgc.solve_zbgc": True,
             "tracers.tr_brine": True, "domain.nblyr": 7,
             "zbgc.tr_bgc_Am": True, "zbgc.tr_bgc_Sil": True,
             "zbgc.tr_bgc_DMS": True, "zbgc.tr_bgc_PON": True,
             "zbgc.tr_bgc_DON": True, "zbgc.tr_bgc_Fe": True,
             "zbgc.tr_bgc_C": True, "zbgc.n_doc": 2, "zbgc.n_dic": 1,
             "zbgc.n_algae": 3},
    "zaero": {"zbgc.z_tracers": True, "tracers.tr_brine": True,
              "domain.nblyr": 7, "zbgc.tr_zaero": True, "zbgc.n_zaero": 3},
    "isotope": {"tracers.tr_iso": True, "domain.n_iso": 3},
    "aerosol": {"tracers.tr_aero": True, "domain.n_aero": 3},
    "alt01": {"tracers.tr_iage": False, "tracers.tr_FY": False},
    "revp": {"dynamics.revised_evp": True},
    "evp1d": {"dynamics.evp_algorithm": "fused_pallas"},
    "evpwide": {"dynamics.evp_algorithm": "wide_halo"},
    "jra55": {"forcing.atm_data_type": "jra55"},
    "ncar": {"forcing.atm_data_type": "ncar"},
    "vanleer": {"dynamics.advection": "vanleer"},
    "seabedLKD": {"dynamics.seabed_stress": True,
                  "dynamics.seabed_stress_method": "LKD"},
    # grid-size presets (gx3/gx1 dimensions on the synthetic grid; real POP
    # grid files plug in via grid.grid_format='pop_nc' + paths)
    "gx3": {"grid.nx_global": 100, "grid.ny_global": 116},
    "gx1": {"grid.nx_global": 320, "grid.ny_global": 384},
    # --- BASELINE config matrix: format-true POP fixture grids + file
    # forcing (io.fixtures; "{FIX}" resolves to the fixture cache root).
    # These are the five BASELINE.json configs as runnable option sets.
    "gx3pop": {"grid.nx_global": 100, "grid.ny_global": 116,
               "grid.grid_format": "pop_bin",
               "grid.grid_type": "displaced_pole",
               "grid.grid_file": "{FIX}/grids/gx3_grid.bin",
               "grid.kmt_file": "{FIX}/grids/gx3_kmt.bin",
               "grid.ew_boundary_type": "cyclic",
               "forcing.atm_data_type": "ncar",
               "forcing.atm_data_dir": "{FIX}/forcing/gx3",
               "forcing.ocn_data_type": "clim",
               "forcing.ocn_data_dir": "{FIX}/forcing/gx3",
               "dynamics.seabed_stress": True,
               "setup.npt_unit": "d", "setup.npt": 5,
               "setup.dumpfreq": "d", "setup.diagfreq": 6,
               "setup.histfreq": ("d", "x", "x", "x", "x")},
    "gx1pop": {"grid.nx_global": 320, "grid.ny_global": 384,
               "grid.grid_format": "pop_bin",
               "grid.grid_type": "displaced_pole",
               "grid.grid_file": "{FIX}/grids/gx1_grid.bin",
               "grid.kmt_file": "{FIX}/grids/gx1_kmt.bin",
               "grid.ew_boundary_type": "cyclic",
               # JRA55 3-hourly file forcing; the fixture materializes
               # records 0..55, so start on day 2 (no pre-record-0 reads)
               "forcing.atm_data_type": "jra55",
               "forcing.atm_data_dir": "{FIX}/forcing/gx1",
               "forcing.ocn_data_type": "clim",
               "forcing.ocn_data_dir": "{FIX}/forcing/gx1",
               "setup.day_init": 2,
               "dynamics.seabed_stress": True,
               "setup.npt_unit": "d", "setup.npt": 5,
               "setup.dumpfreq": "d", "setup.diagfreq": 12,
               "setup.histfreq": ("d", "x", "x", "x", "x")},
    "tx1pop": {"grid.nx_global": 360, "grid.ny_global": 240,
               "grid.grid_format": "pop_bin", "grid.grid_type": "tripole",
               "grid.grid_file": "{FIX}/grids/tx1_grid.bin",
               "grid.kmt_file": "{FIX}/grids/tx1_kmt.bin",
               "grid.ew_boundary_type": "cyclic",
               "grid.ns_boundary_type": "tripole",
               "forcing.atm_data_type": "ncar",
               "forcing.atm_data_dir": "{FIX}/forcing/tx1",
               "forcing.ocn_data_type": "clim",
               "forcing.ocn_data_dir": "{FIX}/forcing/tx1",
               "dynamics.seabed_stress": True,
               "setup.npt_unit": "d", "setup.npt": 5,
               "setup.dumpfreq": "d", "setup.diagfreq": 6,
               "setup.histfreq": ("d", "x", "x", "x", "x")},
    "iopio": {"setup.restart_format": "pio"},
    "diag1": {"setup.diagfreq": 1},
    "histinst": {"setup.hist_avg": False},
    "histdaily": {"setup.histfreq": ("d", "x", "x", "x", "x")},
    "dumpd": {"setup.dumpfreq": "d"},
    "run10day": {"setup.npt_unit": "d", "setup.npt": 10},
    "day1": {"setup.npt_unit": "d", "setup.npt": 1},
    "hours3": {"setup.npt_unit": "1", "setup.npt": 3},
    "run1year": {"setup.npt_unit": "y", "setup.npt": 1},
    "prescribed": {"setup.prescribed_ice": True, "dynamics.kdyn": 0},
    "ktherm1": {"thermo.ktherm": 1},
    "fdrag": {"forcing.formdrag": True},
    "leap": {"setup.calendar_type": "gregorian"},
    "cal360": {"setup.calendar_type": "360day", "setup.days_per_year": 360},
    # --- alternate-physics composites (reference set_nml.alt02..alt07) ----
    "alt02": {"domain.ncat": 1, "grid.kcatbound": -1, "thermo.kitd": 0,
              "domain.distribution_type": "sectrobin",
              "tracers.tr_iage": True, "tracers.tr_FY": True,
              "tracers.tr_lvl": True, "tracers.tr_pond_lvl": False,
              "tracers.tr_pond_topo": False,
              "dynamics.kdyn": 1, "dynamics.revised_evp": True,
              "dynamics.kstrength": 0, "dynamics.krdg_partic": 0,
              "dynamics.krdg_redist": 0,
              "shortwave.shortwave": "ccsm3",
              "shortwave.albedo_type": "ccsm3",
              "forcing.calc_Tsfc": True},
    "alt03": {"domain.ncat": 6, "grid.kcatbound": 2,
              "domain.distribution_type": "sectcart",
              "setup.conserv_check": True,
              "tracers.tr_iage": False, "tracers.tr_FY": False,
              "tracers.tr_lvl": False, "tracers.tr_pond_topo": True,
              "tracers.tr_pond_lvl": False, "tracers.tr_aero": True,
              "domain.n_aero": 3, "forcing.calc_Tsfc": False,
              "dynamics.kdyn": 2, "thermo.ktherm": 1,
              "thermo.sw_redist": True, "thermo.sw_frac": 0.9,
              "thermo.sw_dtemp": 0.02, "thermo.tfrz_option": "linear_salt",
              "dynamics.revised_evp": False, "dynamics.Ktens": 0.0,
              "dynamics.e_yieldcurve": 2.0, "dynamics.seabed_stress": True,
              "forcing.l_mpond_fresh": True},
    "alt04": {"domain.distribution_type": "rake",
              "domain.processor_shape": "slenderX2",
              "domain.distribution_wght": "block",
              "tracers.tr_iage": True, "tracers.tr_FY": True,
              "tracers.tr_lvl": True, "tracers.tr_pond_lvl": True,
              "tracers.tr_aero": True, "domain.n_aero": 3,
              "thermo.kitd": 0, "thermo.hi_min": 0.1, "thermo.ktherm": 1,
              "thermo.sw_redist": True, "thermo.sw_frac": 0.9,
              "thermo.sw_dtemp": 0.02, "thermo.conduct": "MU71",
              "dynamics.kdyn": 1, "dynamics.evp_algorithm": "fused_pallas",
              "forcing.fbot_xfer_type": "Cdn_ocn",
              "shortwave.shortwave": "dEdd", "forcing.formdrag": True,
              "dynamics.advection": "upwind", "dynamics.kstrength": 0,
              "dynamics.krdg_partic": 0, "dynamics.krdg_redist": 0,
              "ponds.frzpnd": "ccsm", "forcing.natmiter": 20,
              "thermo.tfrz_option": "linear_salt"},
    "alt05": {"tracers.tr_iage": False, "tracers.tr_FY": False,
              "tracers.tr_lvl": False, "tracers.tr_pond_lvl": False,
              "tracers.tr_pond_topo": False,
              "shortwave.shortwave": "dEdd"},
    "alt06": {"domain.ncat": 7, "grid.kcatbound": 3, "domain.nslyr": 3,
              "thermo.tfrz_option": "mushy"},
    "alt07": {"dynamics.kdyn": 1, "dynamics.evp_algorithm": "standard_2d",
              "dynamics.ndte": 300, "dynamics.capping_method": "sum",
              "dynamics.visc_method": "avg_strength"},
    # --- box / idealized-grid configurations -------------------------------
    "boxadv": {"domain.nilyr": 1, "grid.kcatbound": 2,
               "grid.ew_boundary_type": "cyclic",
               "grid.ns_boundary_type": "cyclic",
               "forcing.atm_data_type": "box2001",
               "forcing.ocn_data_type": "box2001",
               "tracers.tr_iage": True, "tracers.tr_FY": False,
               "tracers.tr_lvl": True, "thermo.kitd": 1, "thermo.ktherm": 1,
               "dynamics.kdyn": 2, "dynamics.kstrength": 0,
               "dynamics.krdg_partic": 0, "dynamics.krdg_redist": 0,
               "shortwave.shortwave": "ccsm3",
               "shortwave.albedo_type": "constant",
               "thermo.tfrz_option": "mushy"},
    "boxnodyn": {"dynamics.kdyn": 0, "forcing.atm_data_type": "box2001",
                 "forcing.ocn_data_type": "box2001",
                 "grid.grid_format": "rect", "grid.kmt_type": "none"},
    "boxslotcyl": {"domain.nilyr": 1, "setup.dt": 3600.0, "setup.npt": 288,
                   "grid.grid_format": "rect", "grid.kmt_type": "none",
                   "grid.dxrect": 10.e5, "grid.dyrect": 10.e5,
                   "grid.kcatbound": 2,
                   "grid.ew_boundary_type": "closed",
                   "grid.ns_boundary_type": "closed",
                   "tracers.tr_lvl": False, "tracers.tr_pond_lvl": False,
                   "thermo.ktherm": -1, "dynamics.kdyn": -1,
                   "dynamics.kridge": -1, "dynamics.ktransport": 1,
                   "forcing.atm_data_type": "calm",
                   "forcing.ocn_data_type": "box2001"},
    "gbox12": {"grid.nx_global": 12, "grid.ny_global": 12,
               "grid.grid_format": "rect", "grid.kmt_type": "none",
               "forcing.atm_data_type": "box2001",
               "forcing.ocn_data_type": "box2001"},
    "gbox80": {"grid.nx_global": 80, "grid.ny_global": 80,
               "grid.grid_format": "rect", "grid.kmt_type": "none",
               "grid.dxrect": 5.e5, "grid.dyrect": 5.e5,
               "forcing.atm_data_type": "box2001",
               "forcing.ocn_data_type": "box2001"},
    "gbox128": {"grid.nx_global": 128, "grid.ny_global": 128,
                "grid.grid_format": "rect", "grid.kmt_type": "none",
                "forcing.atm_data_type": "box2001",
                "forcing.ocn_data_type": "box2001"},
    "gbox180": {"grid.nx_global": 180, "grid.ny_global": 180,
                "grid.grid_format": "rect", "grid.kmt_type": "none",
                "forcing.atm_data_type": "box2001",
                "forcing.ocn_data_type": "box2001"},
    "kmtislands": {"grid.kmt_type": "boxislands"},
    "boxclosed": {"grid.ew_boundary_type": "closed",
                  "grid.ns_boundary_type": "closed"},
    "boxopen": {"grid.ew_boundary_type": "open",
                "grid.ns_boundary_type": "open"},
    "bccyclic": {"grid.ew_boundary_type": "cyclic",
                 "grid.ns_boundary_type": "cyclic"},
    "bcclosed": {"grid.ew_boundary_type": "closed",
                 "grid.ns_boundary_type": "closed"},
    "bcopen": {"grid.ew_boundary_type": "open",
               "grid.ns_boundary_type": "open"},
    # --- grids -------------------------------------------------------------
    "tx1": {"grid.nx_global": 360, "grid.ny_global": 240,
            "grid.grid_type": "tripole", "grid.grid_format": "tripole_synth"},
    "vargrid": {"grid.scale_dxdy": True, "grid.dxscale": 1.02,
                "grid.dyscale": 1.02},
    "gx3ncarbulk": {"forcing.atm_data_type": "ncar"},
    "gx1apr": {"setup.year_init": 2005, "setup.month_init": 4,
               "setup.day_init": 1, "setup.sec_init": 0},
    "gx1prod": {"setup.year_init": 2005, "setup.npt_unit": "y",
                "setup.npt": 1, "setup.dumpfreq": "m",
                "forcing.fyear_init": 2005},
    # --- timestep / run-length ---------------------------------------------
    "dt1hr": {"setup.dt": 3600.0},
    "dt30min": {"setup.dt": 1800.0},
    "dt3456s": {"setup.dt": 3456.0},
    "run1day": {"setup.npt_unit": "d", "setup.npt": 1},
    "run2day": {"setup.npt_unit": "d", "setup.npt": 2},
    "run3day": {"setup.npt_unit": "d", "setup.npt": 3},
    "run5day": {"setup.npt_unit": "d", "setup.npt": 5},
    "run60day": {"setup.npt_unit": "d", "setup.npt": 60},
    "run90day": {"setup.npt_unit": "d", "setup.npt": 90},
    "run8year": {"setup.npt_unit": "y", "setup.npt": 8},
    "run10year": {"setup.npt_unit": "y", "setup.npt": 10},
    # --- decomposition-analysis fragments (domain_nml; PARITY 2.2 Δ) -------
    "droundrobin": {"domain.distribution_type": "roundrobin"},
    "dsectcart": {"domain.distribution_type": "sectcart"},
    "dsectrobin": {"domain.distribution_type": "sectrobin"},
    "dspiralcenter": {"domain.distribution_type": "spiralcenter"},
    "dspacecurve": {"domain.distribution_type": "spacecurve"},
    "drake": {"domain.distribution_type": "rake"},
    "dwblock": {"domain.distribution_wght": "block"},
    "dwlat": {"domain.distribution_wght": "latitude"},
    "dslenderX1": {"domain.processor_shape": "slenderX1"},
    "dslenderX2": {"domain.processor_shape": "slenderX2"},
    "dsquareice": {"domain.processor_shape": "square-ice"},
    "dsquarepop": {"domain.processor_shape": "square-pop"},
    # --- diagnostics / history ---------------------------------------------
    "diag24": {"setup.diagfreq": 24},
    "diagpt1": {"setup.print_points": True},
    "bigdiag": {"setup.print_points": True, "setup.conserv_check": True,
                "setup.debug_model": True},
    "histhrly": {"setup.histfreq": ("h", "x", "x", "x", "x")},
    "histmon": {"setup.histfreq": ("m", "x", "x", "x", "x")},
    "timerstats": {},     # timers always collect min/max/mean (utils/timers)
    # --- initial condition / forcing ---------------------------------------
    "icdefault": {"setup.ice_ic": "default"},
    "icnone": {"setup.ice_ic": "none"},
    "jra55do": {"forcing.atm_data_type": "jra55"},
    "atmbndyconstant": {"forcing.atmbndy": "constant"},
    "atmbndymixed": {"forcing.atmbndy": "mixed"},
    "restore5": {"forcing.restore_ice": True, "forcing.trestore": 3},
    "bdyrestore": {"forcing.restore_ice": True, "forcing.restore_ocn": True},
    "yi2008": {"setup.year_init": 2008, "forcing.fyear_init": 2008},
    # --- dynamics / solver variants ----------------------------------------
    "nonlin5000": {"dynamics.kdyn": 3, "dynamics.maxits_nonlin": 5000},
    "seabedprob": {"dynamics.seabed_stress": True,
                   "dynamics.seabed_stress_method": "probabilistic"},
    # --- column-physics variants -------------------------------------------
    "fsd1": {"tracers.tr_fsd": True, "domain.nfsd": 1},
    "fsd12ww3": {"tracers.tr_fsd": True, "domain.nfsd": 12,
                 "forcing.wave_spec_type": "constant"},
    "snw30percent": {"tracers.tr_snow": True, "snow.snwredist": "bulk",
                     "snow.snwlvlfac": 0.3, "domain.nslyr": 5},
    "snwitdrdg": {"tracers.tr_snow": True, "snow.snwredist": "ITDrdg",
                  "domain.nslyr": 5, "snow.rhosnew": 100.0,
                  "snow.rhosmin": 100.0, "snow.rhosmax": 450.0,
                  "snow.windmin": 10.0, "snow.drhosdwind": 27.3,
                  "snow.snwlvlfac": 0.3},
    "bgcsklclim": {"zbgc.skl_bgc": True, "zbgc.nit_data": "clim",
                   "zbgc.sil_data": "clim"},
    "bgczclim": {"zbgc.z_tracers": True, "zbgc.solve_zbgc": True,
                 "tracers.tr_brine": True, "domain.nblyr": 7,
                 "zbgc.nit_data": "clim", "zbgc.sil_data": "clim"},
    # --- IO / precision -----------------------------------------------------
    "iocdf1": {"setup.restart_format": "cdf1"},
    "ionetcdf": {"setup.restart_format": "cdf1"},
    "iopio2": {"setup.restart_format": "pio"},
    "iohdf5": {"setup.restart_format": "hdf5",
               "setup.history_format": "hdf5"},
    "histhdf5": {"setup.history_format": "hdf5"},
    "resthdf5": {"setup.restart_format": "hdf5"},
    "histchunk": {"setup.history_chunksize": (64, 64)},
    "ioasync": {"setup.io_async": True},
    "precision8": {"dtype": "float64"},
    "cmip": {"setup.hist_cmip": True},
    # --- QC (5-year daily-output statistical acceptance run, set_nml.qc) ---
    "qc": {"setup.npt_unit": "y", "setup.npt": 5, "setup.year_init": 2005,
           "setup.diagfreq": 24, "setup.dumpfreq": "m",
           "setup.histfreq": ("d", "x", "x", "x", "x"),
           "setup.hist_avg": False, "forcing.fyear_init": 2005,
           "forcing.ycycle": 1},
}


#: relative tolerance of the report-only baseline comparison
BCMP_RTOL = 1e-3


def _parse_sets(pairs):
    out = {}
    for kv in pairs or []:
        k, _, v = kv.partition("=")
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def _resolve_fixtures(overrides: dict) -> dict:
    """Substitute '{FIX}' with the fixture root, writing the baseline
    fixtures there on first use (io.fixtures)."""
    if not any(isinstance(v, str) and "{FIX}" in v
               for v in overrides.values()):
        return overrides
    from ..io.fixtures import ensure_baseline_fixtures, fixtures_root
    ensure_baseline_fixtures()
    root = fixtures_root()
    return {k: (v.replace("{FIX}", root)
                if isinstance(v, str) and "{FIX}" in v else v)
            for k, v in overrides.items()}


def build_config(args):
    """Config() with the comma-separated option sets of `args.opts`, then
    the `--set k=v` pairs of `args.set`, applied in order."""
    from ..config import Config
    cfg = Config()
    for opt in (args.opts or "").split(","):
        if opt:
            if opt not in OPTION_SETS:
                sys.exit(f"unknown option set '{opt}' "
                         f"(available: {', '.join(OPTION_SETS)})")
            cfg = cfg.with_overrides(**_resolve_fixtures(OPTION_SETS[opt]))
    return cfg.with_overrides(**_resolve_fixtures(_parse_sets(args.set)))


def _diags(m) -> dict:
    from ..model.diagnostics import runtime_diags
    return {k: float(v) for k, v in runtime_diags(m.grid, m.state).items()}


def cmd_case(args):
    """A case directory: `config.json` (the option sets' overrides, then
    the --set pairs) and a `run.py` that runs it with history on
    `--device` (default cuda)."""
    os.makedirs(args.dir, exist_ok=True)
    overlay = {}
    for opt in (args.opts or "").split(","):
        if opt:
            if opt not in OPTION_SETS:
                sys.exit(f"unknown option set '{opt}' "
                         f"(available: {', '.join(OPTION_SETS)})")
            overlay.update(OPTION_SETS[opt])
    overlay.update(_parse_sets(args.set))
    with open(os.path.join(args.dir, "config.json"), "w") as f:
        json.dump(overlay, f, indent=2)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    runner = os.path.join(args.dir, "run.py")
    with open(runner, "w") as f:
        f.write(
            "#!/usr/bin/env python3\n"
            "import json, os, sys\n"
            f"sys.path.insert(0, {root!r})\n"
            "from cice_tpu_torch.cli.main import _resolve_fixtures\n"
            "from cice_tpu_torch.config import Config\n"
            "from cice_tpu_torch.model.driver import Model\n"
            "here = os.path.dirname(os.path.abspath(__file__))\n"
            "with open(os.path.join(here, 'config.json')) as f:\n"
            "    over = _resolve_fixtures(json.load(f))\n"
            "cfg = Config().with_overrides(**over)\n"
            f"m = Model(cfg, device={args.device!r}, enable_history=True)\n"
            "m.run()\n"
            "print('done at', m.calendar.timestamp())\n")
    os.chmod(runner, 0o755)
    print(f"case created: {args.dir}")
    return 0


def cmd_run(args):
    from ..model.driver import Model
    from ..kernels import launch_counts
    from ..utils.timers import sync_counts
    m = Model(build_config(args), device=args.device,
              enable_history=args.history)
    n = args.steps if args.steps else None
    t0 = time.time()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if m.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            m.run(n)
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "run.pt.trace.json")
        prof.export_chrome_trace(trace)
        print(f"profile: {trace}")
    else:
        m.run(n)
    wall = time.time() - t0
    print(json.dumps({"istep": m.calendar.istep, "wall_s": round(wall, 2),
                      "timers": {k: round(v, 2) for k, v in m.timers.items()},
                      "syncs": sync_counts(),
                      "launches": launch_counts(),
                      "diags": _diags(m)}))
    return 0


def _diag_series(cfg, device, nsteps=6):
    """Run nsteps and collect the global diagnostics after each (the
    reference comparelog.csh fingerprint)."""
    from ..model.driver import Model
    m = Model(cfg, device=device)
    series = []
    for _ in range(nsteps):
        m.step()
        series.append(_diags(m))
    return m, series


def compare_series(a, b, rtol=0.0):
    """comparelog.csh analogue: per-step global sums must match (bit for
    bit by default). Returns the (step, key, va, vb) mismatches."""
    errs = []
    if len(a) != len(b):
        errs.append((-1, "nsteps", float(len(a)), float(len(b))))
    for i, (ra, rb) in enumerate(zip(a, b)):
        for k, va in ra.items():
            vb = rb.get(k)
            if vb is None:
                errs.append((i, k, va, float("nan")))
            elif abs(va - vb) > rtol * max(abs(va), abs(vb)):
                errs.append((i, k, va, vb))
    return errs


def largest_rel_deltas(a, b) -> dict:
    """{key: largest |va - vb| / max(|va|, |vb|) over the common steps}."""
    out: dict = {}
    for ra, rb in zip(a, b):
        for k, va in ra.items():
            vb = rb.get(k)
            if vb is None:
                continue
            scale = max(abs(va), abs(vb))
            rel = abs(va - vb) / scale if scale > 0 else 0.0
            out[k] = max(out.get(k, 0.0), rel)
    return out


def _test_smoke(cfg, device) -> bool:
    import torch
    from ..model.driver import Model
    m = Model(cfg, device=device)
    m.run(6)
    return bool(torch.isfinite(m.state.vice).all()) and \
        float(m.state.aice.max()) <= 1.0 + 1e-6


def _test_restart(cfg, device) -> bool:
    """6 steps equal 3 steps, a dump, a fresh Model from it and 3 more,
    bit for bit."""
    import tempfile

    import torch
    from ..io.restart import read_restart
    from ..model.driver import Model
    from ..model.state import state_leaves
    with tempfile.TemporaryDirectory() as td:
        cfg = cfg.with_overrides(**{
            "setup.restart_dir": td,
            "setup.pointer_file": os.path.join(td, "ice.restart_file")})
        m1 = Model(cfg, device=device)
        m1.run(6)
        m2 = Model(cfg, device=device)
        m2.run(3)
        path = m2.write_restart()
        m2.flush_io()                 # durability barrier (io_async)
        m3 = Model(cfg, device=device)
        m3.state, m3.calendar = read_restart(path, m3.state)
        m3.run(3)
        return all(torch.equal(a, b) for a, b in zip(
            state_leaves(m1.state), state_leaves(m3.state)))


def baseline_model(cfg, device):
    """The Model a baseline test runs: the option set's whole length with
    history on."""
    from ..model.driver import Model
    return Model(cfg, device=device, enable_history=True)


def finish_baseline(m, label: str, archive_dir: str | None = None,
                    compare_dir: str | None = None) -> dict:
    """The oracle of a finished baseline run (finite vice, aice <= 1,
    extent in both hemispheres), the archive `<archive_dir>/<label>.json`
    and, with `compare_dir`, the report-only comparison of the series
    with `<compare_dir>/<label>.json` at BCMP_RTOL. Returns {"ok",
    "final", "archive", "deltas" (None without a comparison),
    "largest_rel"}."""
    import torch
    from ..io.fixtures import fixtures_root
    d = _diags(m)
    ok = bool(torch.isfinite(m.state.vice).all())
    ok &= float(m.state.aice.max()) <= 1.0 + 1e-6
    # a 5-day global run must carry ice in both hemispheres
    ok &= d.get("extent_nh", 0.0) > 0.0 and d.get("extent_sh", 0.0) > 0.0
    bdir = archive_dir or os.path.join(fixtures_root(), "baselines")
    os.makedirs(bdir, exist_ok=True)
    path = os.path.join(bdir, f"{label}.json")
    with open(path, "w") as f:
        json.dump({"final": d, "series": m.diag_log,
                   "timers": {k: round(float(v), 2)
                              for k, v in m.timers.items()}}, f)
    print(f"    {label}: steps={m.calendar.istep} "
          f"extent_nh={d.get('extent_nh', 0):.3e} "
          f"extent_sh={d.get('extent_sh', 0):.3e} archived -> {path}")
    out = dict(ok=ok, final=d, archive=path, deltas=None, largest_rel=None)
    if compare_dir:
        ref_path = os.path.join(compare_dir, f"{label}.json")
        if not os.path.exists(ref_path):
            print(f"    bcmp[{label}]: no committed baseline at {ref_path}")
            return out
        with open(ref_path) as f:
            base = json.load(f)["series"]
        errs = compare_series(base, m.diag_log, rtol=BCMP_RTOL)
        out.update(deltas=errs,
                   largest_rel=largest_rel_deltas(base, m.diag_log))
        print(f"    bcmp[{label}] vs {ref_path}: "
              f"{'PASS' if not errs else 'DIFF'} ({len(errs)} deltas at "
              f"rtol={BCMP_RTOL})")
        for i, k, va, vb in errs[:5]:
            print(f"      step {i} {k}: baseline {va!r} vs run {vb!r}")
    return out


def _leaf_names(state) -> list:
    """Names of `state_leaves(state)`, in their order."""
    import dataclasses
    from ..model.state import State
    names = []
    for f in dataclasses.fields(State):
        if f.name == "trcrn":
            names += [f"trcrn.{k}" for k in sorted(state.trcrn)]
        else:
            names.append(f.name)
    return names


def _test_decomp(cfg, device) -> bool:
    """Decomposition invariance (test_decomp.script / decomp_suite.ts; the
    JAX package's `_test_decomp`): 2 coupled steps on one process against
    the state sharded on 2x4 and on 4x2 ranks, f64. The 8 ranks are
    spawned processes joined by gloo, on `device` (on the card they share
    it). The oracle is the JAX package's: every float leaf within 1e-4 of
    its largest value (leaves below 1e-6 skipped), ints and bools equal.
    The ranks do the same operations on the same values as the one
    process, so the largest deviation printed is expected to be 0.0,
    except under VP (kdyn=3), whose inner products add the ranks' partial
    sums in another order: at this 32x32 size VP's own envelope (its
    stresses move by 5e-4 of their scale, dynanderson's by 1e-3, when
    vicen moves by 1 ulp in f64) exceeds the oracle, which the JAX
    package's VP fails too."""
    import tempfile

    import numpy as np

    from ..model.driver import Model
    from ..model.state import state_leaves
    from ..parallel import spawn
    cfg = cfg.with_overrides(dtype="float64")
    one = Model(cfg, device=device)
    one.run(2)
    ref = [x.detach().cpu().numpy() for x in state_leaves(one.state)]
    names = _leaf_names(one.state)
    shapes = ((2, 4), (4, 2))
    with tempfile.TemporaryDirectory() as wd:
        res = spawn.launch([("sharded_steps", dict(
            cfg=cfg, nsteps=2, shape=shape, device=str(device)), 8)
            for shape in shapes], 8, wd)
    ok = True
    for shape, r in zip(shapes, res):
        if len({x["digest"] for x in r}) != 1:
            print(f"  decomp {shape[0]}x{shape[1]}: the ranks' gathered "
                  "states differ")
            ok = False
        worst = 0.0
        for name, a, b in zip(names, r[0]["out"], ref):
            if b.dtype.kind == "f":
                scale = float(np.abs(b).max()) if b.size else 0.0
                if scale > 1e-6:
                    d = float(np.abs(a - b).max())
                    worst = max(worst, d / scale)
                    if d > 1e-4 * scale:
                        print(f"  decomp mismatch {name}: {d:.3e} vs "
                              f"scale {scale:.3e}")
                        ok = False
            elif not np.array_equal(a, b):
                print(f"  decomp mismatch {name} (int/bool)")
                ok = False
        print(f"  decomp {shape[0]}x{shape[1]} against one process: "
              f"largest deviation {worst!r} of the field's scale over "
              f"{len(ref)} state leaves")
    return ok


def _test_baseline(cfg, label, device, archive_dir=None,
                   compare_dir=None) -> bool:
    m = baseline_model(cfg, device)
    m.run()
    return finish_baseline(m, label, archive_dir, compare_dir)["ok"]


def _default_test_cfg(args, cfg):
    if args.type == "baseline" or cfg.grid.grid_file:
        return cfg          # baseline configs run at their true size
    if not args.set or not any("nx_global" in s for s in args.set):
        cfg = cfg.with_overrides(**{
            "grid.nx_global": 32, "grid.ny_global": 32,
            "grid.grid_format": "rect", "grid.kmt_type": "none",
            "forcing.atm_data_type": "box2001",
            "forcing.ocn_data_type": "box2001",
            "dynamics.ndte": 20, "thermo.nit": 4})
    return cfg


def cmd_test(args):
    cfg = _default_test_cfg(args, build_config(args))
    t0 = time.time()
    label = (args.opts or "base").replace(",", "+")
    bgen, bcmp = getattr(args, "bgen", None), getattr(args, "bcmp", None)
    if args.type == "baseline":
        ok = _test_baseline(cfg, label, args.device, bgen, bcmp)
    elif bgen or bcmp:
        # baseline generate/compare of the per-step diagnostics series
        # (cice.setup --bgen/--bcmp, ug_testing.rst:70-86)
        key = f"{args.type}_{label}.json"
        _, series = _diag_series(cfg, args.device)
        if bgen:
            os.makedirs(bgen, exist_ok=True)
            with open(os.path.join(bgen, key), "w") as f:
                json.dump(series, f)
            print(f"BGEN  {key} ({time.time() - t0:.1f}s)")
            return 0
        with open(os.path.join(bcmp, key)) as f:
            errs = compare_series(json.load(f), series)
        print(f"{'PASS' if not errs else 'FAIL'} bcmp_{args.type} vs {key} "
              f"({len(errs)} mismatches, {time.time() - t0:.1f}s)")
        for i, k, va, vb in errs[:10]:
            print(f"    step {i} {k}: baseline {va!r} vs run {vb!r}")
        return 0 if not errs else 1
    else:
        ok = {"smoke": _test_smoke, "restart": _test_restart,
              "decomp": _test_decomp}[args.type](cfg, args.device)
    print(f"{'PASS' if ok else 'FAIL'} test_{args.type} "
          f"({time.time() - t0:.1f}s)")
    return 0 if ok else 1


# suite tables (tests/*.ts analogue), the JAX package's. Rows: (type,
# opts[, bfbcomp-opts]): the optional third column makes another row's
# diagnostics series the bit-for-bit oracle of this row (base_suite.ts
# 5th column semantics).
SUITES = {
    "quick": [("smoke", ""), ("restart", "")],
    "dynamics": [("smoke", ""), ("smoke", "gridc"), ("smoke", "dynpicard"),
                 ("smoke", "eap"), ("smoke", "nodyn"), ("smoke", "upwind")],
    "base": [("smoke", ""), ("restart", ""), ("smoke", "gridc"),
             ("smoke", "dynpicard"), ("smoke", "upwind"),
             ("restart", "upwind"), ("smoke", "seasonal")],
    "decomp": [("decomp", ""), ("decomp", "upwind")],
    "reprosum": [("smoke", "", ""), ("smoke", "ndte120")],
    # alternate-physics sweep (base_suite.ts alt* rows)
    "alt": [("smoke", "alt01"), ("smoke", "alt02"), ("smoke", "alt03"),
            ("smoke", "alt05"), ("smoke", "alt06"), ("smoke", "alt07")],
    # IO backends x restart exactness (io_suite.ts)
    "io": [("restart", ""), ("restart", "iocdf1"), ("restart", "iopio"),
           ("restart", "ioasync"), ("smoke", "histdaily"),
           ("smoke", "histinst")],
    # column-physics option sweep
    "column": [("smoke", "mushy"), ("smoke", "bl99"), ("smoke", "dedd"),
               ("smoke", "pondlvl"), ("smoke", "pondtopo"),
               ("smoke", "pondsealvl"), ("smoke", "snwgrain"),
               ("smoke", "fsd12"), ("smoke", "saltflux"),
               ("smoke", "congel")],
    # the five BASELINE.json configurations at production size
    "baseline": [("baseline", "gx3pop"), ("baseline", "gx1pop"),
                 ("baseline", "tx1pop"), ("baseline", "gx1pop,dynpicard"),
                 ("baseline", "gx1pop,gridc")],
    # the same with the gx1/tx1 rows' clocks shortened
    "baseline_ci": [("baseline", "gx3pop"), ("baseline", "gx1pop,hours3"),
                    ("baseline", "tx1pop,day1"),
                    ("baseline", "gx1pop,dynpicard,hours3"),
                    ("baseline", "gx1pop,gridc,hours3")],
}


def cmd_suite(args):
    """Run a suite's rows; a row that raises fails and the suite goes on.
    Exits 0 only if every row passed."""
    rows = SUITES.get(args.name)
    if rows is None:
        sys.exit(f"unknown suite '{args.name}' "
                 f"(available: {', '.join(SUITES)})")
    results = []
    series_cache = {}

    def config(opts):
        ns = argparse.Namespace(opts=opts, set=args.set, type="smoke")
        return _default_test_cfg(ns, build_config(ns))

    for row in rows:
        ttype, opts = row[0], row[1]
        bfb_ref = row[2] if len(row) > 2 else None
        try:
            if bfb_ref is not None and ttype == "smoke":
                # this row's series against the referenced row's (run and
                # cached on demand); ref == opts is run-to-run repro
                if bfb_ref not in series_cache:
                    _, series_cache[bfb_ref] = _diag_series(config(bfb_ref),
                                                            args.device)
                _, series = _diag_series(config(opts), args.device)
                ok = not compare_series(series_cache[bfb_ref], series)
                series_cache[opts] = series
            else:
                ok = cmd_test(argparse.Namespace(
                    opts=opts, set=args.set, type=ttype,
                    device=args.device, bgen=None, bcmp=None)) == 0
        except Exception as e:     # a crashed row fails, the suite goes on
            print(f"  ERROR {ttype} {opts}: {type(e).__name__}: {e}")
            ok = False
        results.append((ttype, opts, ok))
    npass = sum(1 for *_, ok in results if ok)
    for ttype, opts, ok in results:
        print(f"  {'PASS' if ok else 'FAIL'}  {ttype:8s} {opts}")
    print(f"{npass}/{len(results)} passed")
    return 0 if npass == len(results) else 1


def cmd_perf(args):
    from .perf import run_perf
    sizes = tuple(tuple(int(v) for v in s.split("x"))
                  for s in args.sizes.split(","))
    run_perf(sizes=sizes, ndte=args.ndte,
             mesh_devices=tuple(int(v) for v in args.mesh.split(",")),
             weak_tile=tuple(int(v) for v in args.weak_tile.split("x")),
             device=args.device)
    return 0


def cmd_qc(args):
    from . import qc
    return qc.main([args.dir_a, args.dir_b, args.var])


def cmd_plot2d(args):
    from .plots import plot2d
    print("\n".join(plot2d(args.paths, args.field, args.out)))
    return 0


def cmd_timeseries(args):
    from .plots import timeseries
    print(timeseries(args.diag_path, args.keys, args.out))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cice_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--opts", "-s", default="",
                       help="comma-separated option sets")
        p.add_argument("--set", action="append", metavar="KEY=VAL")
        p.add_argument("--device", default="cuda",
                       help="torch device: cuda (default) or cpu")

    p_run = sub.add_parser("run", help="run the model")
    common(p_run)
    p_run.add_argument("--steps", type=int, default=None)
    p_run.add_argument("--history", action="store_true")
    p_run.add_argument("--profile", metavar="DIR", default=None,
                       help="write a torch.profiler trace of the time loop "
                            "to DIR (Chrome trace; chrome://tracing or "
                            "perfetto)")
    p_run.set_defaults(fn=cmd_run)

    p_case = sub.add_parser("case", help="create a case directory")
    common(p_case)
    p_case.add_argument("--dir", required=True)
    p_case.set_defaults(fn=cmd_case)

    p_test = sub.add_parser("test", help="run a single test")
    common(p_test)
    p_test.add_argument("--type", choices=["smoke", "restart", "decomp",
                                           "baseline"], default="smoke")
    p_test.add_argument("--bgen", default=None, metavar="DIR",
                        help="write the baseline (series) there")
    p_test.add_argument("--bcmp", default=None, metavar="DIR",
                        help="compare against a stored baseline")
    p_test.set_defaults(fn=cmd_test)

    p_suite = sub.add_parser("suite", help="run a test suite")
    p_suite.add_argument("--name", default="quick")
    p_suite.add_argument("--set", action="append", metavar="KEY=VAL")
    p_suite.add_argument("--device", default="cuda",
                         help="torch device: cuda (default) or cpu")
    p_suite.set_defaults(fn=cmd_suite)

    p_perf = sub.add_parser(
        "perf", help="EVP performance sweep through K1 (perf_suite.ts "
        "analogue)")
    p_perf.add_argument("--sizes", default="192x160,384x320,768x640",
                        help="comma list of NYxNX grid sizes")
    p_perf.add_argument("--ndte", type=int, default=120)
    p_perf.add_argument("--mesh", default="1",
                        help="rank counts of the scaling sweeps (above 1: "
                        "spawned ranks, the state sharded)")
    p_perf.add_argument("--weak-tile", default="192x160",
                        help="per-device tile of the weak-scaling sweep")
    p_perf.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    p_perf.set_defaults(fn=cmd_perf)

    p_qc = sub.add_parser(
        "qc", help="two-stage statistical QC comparison of two runs")
    p_qc.add_argument("dir_a")
    p_qc.add_argument("dir_b")
    p_qc.add_argument("--var", default="hi")
    p_qc.set_defaults(fn=cmd_qc)

    p_p2 = sub.add_parser("plot2d", help="map plot of a history field "
                          "(ciceplots2d.py analogue)")
    p_p2.add_argument("paths", nargs="+")
    p_p2.add_argument("--field", "-f", default="aice")
    p_p2.add_argument("--out", default=None)
    p_p2.set_defaults(fn=cmd_plot2d)

    p_ts = sub.add_parser("timeseries", help="diagnostics time-series plot "
                          "(timeseries.py analogue)")
    p_ts.add_argument("diag_path")
    p_ts.add_argument("--keys", "-k", action="append", default=None)
    p_ts.add_argument("--out", default=None)
    p_ts.set_defaults(fn=cmd_timeseries)

    args = ap.parse_args(argv)
    return args.fn(args)
