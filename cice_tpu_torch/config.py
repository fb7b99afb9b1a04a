"""Typed model configuration mirroring CICE's runtime namelist groups.

PyTorch port: a copy of cice_tpu/config.py, except that
`Config.np_dtype` returns a `torch.dtype`, the remap engine name 'xla'
selects the plain PyTorch path, and `gx1pop_dyn` builds the first port
slice's configuration.

The reference reads a Fortran namelist `ice_in` with ~13 groups
(reference: cicecore/cicedyn/general/ice_init.F90:59-2966 `input_data`,
configuration/scripts/ice_in). Here the same knobs are a tree of frozen
(hashable) dataclasses. Field names follow the reference namelists so CICE users can map
their setups 1:1; option fragments (`set_nml.*`) become `Config.replace(...)`
chains / dict overlays via `from_overrides`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch


def _replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


@dataclass(frozen=True)
class SetupConfig:
    # reference: setup_nml in configuration/scripts/ice_in
    days_per_year: int = 365
    use_leap_years: bool = False
    year_init: int = 2005
    month_init: int = 1
    day_init: int = 1
    sec_init: int = 0
    dt: float = 3600.0              # thermodynamics/coupling timestep (s)
    npt: int = 24                   # number of steps (interpreted per npt_unit)
    npt_unit: str = "1"             # '1'=steps, 'd','m','y','h','s'
    ndtd: int = 1                   # dynamics subcycles per thermo step
    runtype: str = "initial"        # 'initial' | 'continue'
    prescribed_ice: bool = False    # AMIP prescribed concentration (ice_prescribed_mod)
    ice_ic: str = "default"         # 'default' | 'none' | path
    restart: bool = False
    restart_dir: str = "./restart/"
    restart_file: str = "iced"
    restart_format: str = "npz"     # 'npz' (root write) | 'pio' (shard-wise, io_pio2 analogue) | 'cdf1' (netCDF-3 classic) | 'hdf5' (netCDF-4/HDF5, chunked+deflated)
    io_async: bool = False          # background native writer for history/restart (io_pio2 latency-hiding analogue)
    io_nthreads: int = 2            # worker threads for the async writer
    pointer_file: str = "./restart/ice.restart_file"
    dumpfreq: str = "y"
    dumpfreq_n: int = 1
    dump_last: bool = False
    diagfreq: int = 24
    # history backend format (reference setup_nml history_format +
    # hdf5 chunk/deflate knobs, ug_case_settings.rst; 'cdf1' = netCDF-3
    # classic, 'hdf5' = netCDF-4-style HDF5 with chunking & deflate)
    history_format: str = "cdf1"    # 'cdf1' | 'hdf5' | 'npz'
    history_deflate: int = 1        # hdf5 gzip level 0-9
    history_chunksize: Tuple[int, int] = (0, 0)  # (ny, nx) chunk; 0 = auto
    histfreq: Tuple[str, ...] = ("m", "x", "x", "x", "x")
    histfreq_n: Tuple[int, ...] = (1, 1, 1, 1, 1)
    hist_avg: bool | Tuple[bool, ...] = True  # one value or per-stream tuple (reference: max_nstrm logicals)
    history_dir: str = "./history/"
    hist_cmip: bool = False         # add CMIP si* alias fields (f_CMIP)
    # per-field stream assignment (reference icefields_nml f_* chars):
    # (("aice", "md"), ("sidir", "x"), ...); 'x' disables a field, chars
    # name the histfreq streams it joins; unlisted fields join every stream
    hist_field_freq: Tuple[Tuple[str, str], ...] = ()
    history_file: str = "iceh"
    calendar_type: str = "noleap"   # 'noleap' | 'gregorian' | '360day'
    conserv_check: bool = False
    # point probes & per-stage debug dumps (ice_diagnostics print_points /
    # debug_model_{step,i,j} namelist)
    print_points: bool = False
    latpnt: Tuple[float, float] = (90.0, -65.0)
    lonpnt: Tuple[float, float] = (0.0, -45.0)
    debug_model: bool = False
    debug_model_i: int = -1         # -1: use latpnt/lonpnt probe 1
    debug_model_j: int = -1
    debug_model_step: int = 0       # start dumping at this step


@dataclass(frozen=True)
class GridConfig:
    # reference: grid_nml
    grid_format: str = "rect"       # 'rect' | 'latlon' | 'pop_nc' | 'displaced_pole' | 'tripole'
    grid_type: str = "rectangular"  # 'rectangular' | 'displaced_pole' | 'tripole' | 'regional'
    grid_ice: str = "B"             # 'B' | 'C' | 'CD'
    nx_global: int = 100
    ny_global: int = 116
    dxrect: float = 30.0e5          # cm (rectgrid spacing), reference ice_grid.F90:119
    dyrect: float = 30.0e5
    lonrefrect: float = -156.5
    latrefrect: float = 71.35
    scale_dxdy: bool = False        # variable rect spacing (rectgrid_scale_dxdy:2772)
    dxscale: float = 1.0            # geometric spacing ratio per cell, x
    dyscale: float = 1.0
    kmt_type: str = "default"       # 'default' | 'none' | 'channel' | 'wall' | 'boxislands'
    ew_boundary_type: str = "cyclic"   # 'cyclic' | 'closed' | 'open'
    ns_boundary_type: str = "open"     # 'open' | 'closed' | 'cyclic' | 'tripole' | 'tripoleT'
    kcatbound: int = 1              # ITD category boundary scheme (0 orig, 1 new, 2 WMO, -1 single)
    grid_file: str = ""
    kmt_file: str = ""


@dataclass(frozen=True)
class DomainConfig:
    # Dimensions that size state arrays (reference: shared/ice_domain_size.F90).
    ncat: int = 5
    nilyr: int = 7
    nslyr: int = 1
    nblyr: int = 1
    nfsd: int = 1
    n_aero: int = 0
    n_iso: int = 0
    # domain_nml block-distribution analysis knobs (ice_domain.F90:108;
    # consumed by parallel/decomp.py tooling — correctness never depends on
    # them under SPMD, see PARITY 2.2)
    distribution_type: str = "cartesian"
    distribution_wght: str = "latitude"
    processor_shape: str = "square-ice"


@dataclass(frozen=True)
class TracerConfig:
    # reference: tracer_nml
    tr_iage: bool = True
    tr_FY: bool = True
    tr_lvl: bool = True
    tr_pond_lvl: bool = True
    tr_pond_topo: bool = False
    tr_pond_sealvl: bool = False
    tr_snow: bool = False
    tr_fsd: bool = False
    tr_iso: bool = False
    tr_aero: bool = False
    tr_brine: bool = False         # dynamic brine height (fbri)


@dataclass(frozen=True)
class ThermoConfig:
    # reference: thermo_nml
    ktherm: int = 1                 # 0 zero-layer, 1 BL99, 2 mushy
    kitd: int = 1                   # 0 delta, 1 linear remap
    conduct: str = "bubbly"         # 'MU71' | 'bubbly'
    tfrz_option: str = "mushy"      # 'minus1p8' | 'linear_salt' | 'mushy' | 'constant'
    ksno: float = 0.30
    a_rapid_mode: float = 0.5e-3
    Rac_rapid_mode: float = 10.0
    aspect_rapid_mode: float = 1.0
    dSdt_slow_mode: float = -5.0e-8
    phi_c_slow_mode: float = 0.05
    phi_i_mushy: float = 0.85
    congel_freeze: str = "two-step"  # 'two-step' (mushy congelation) | 'one-step' (freeze solid immediately; ug_case_settings.rst:709)
    saltflux_option: str = "constant"  # 'constant' (ice_ref_salinity) | 'prognostic' (bulk sice, needs ktherm=2; ug_case_settings.rst:782)
    ice_ref_salinity: float = 4.0    # ppt, for saltflux_option='constant'
    hi_min: float = 0.01
    sw_redist: bool = False
    sw_frac: float = 0.9
    sw_dtemp: float = 0.02
    nit: int = 50                   # max Newton iterations (fixed count under jit)


@dataclass(frozen=True)
class DynamicsConfig:
    # reference: dynamics_nml; ice_dyn_shared.F90:37-139
    kdyn: int = 1                   # 0 off, 1 EVP, 2 EAP, 3 VP, -1 fixed
    ndte: int = 120                 # EVP subcycles
    revised_evp: bool = False
    evp_algorithm: str = "standard_2d"   # 'standard_2d' | 'fused_pallas' | 'wide_halo'
    evp_wide_k: int = 8             # wide_halo: subcycles fused per exchange
    elasticDamp: float = 0.36
    arlx: float = 300.0             # revised-EVP alpha
    brlx: float = 300.0             # revised-EVP beta
    e_yieldcurve: float = 2.0
    e_plasticpot: float = 2.0
    visc_method: str = "avg_zeta"   # C-grid: 'avg_strength' | 'avg_zeta'
    capping_method: str = "max"     # 'max' (Hibler79) | 'sum' (Kreyscher2000)
    deltaminEVP: float = 1e-11      # (1/s)
    deltaminVP: float = 2e-9
    Ktens: float = 0.0
    kstrength: int = 1              # 0 Hibler79, 1 Rothrock75
    krdg_partic: int = 1
    krdg_redist: int = 1
    mu_rdg: float = 3.0
    Cf: float = 17.0
    Pstar: float = 2.75e4
    Cstar: float = 20.0
    seabed_stress: bool = False
    seabed_stress_method: str = "LKD"   # 'LKD' | 'probabilistic'
    k1: float = 7.5e-3              # LKD seabed stress parameter
    k2: float = 15.0
    alphab: float = 20.0
    threshold_hw: float = 30.0
    coriolis: str = "latitude"      # 'latitude' | 'constant' | 'zero'
    ssh_stress: str = "geostrophic" # 'geostrophic' | 'coupled'
    kridge: int = 1                 # 1 ridging on, -1 off
    ktransport: int = 1             # 1 transport on, -1 off
    advection: str = "remap"        # 'remap' (exact incremental remapping)
                                    # | 'remap_q' (cheap quadrature variant)
                                    # | 'vanleer' | 'upwind' | 'none'
    l_dp_midpt: bool = True         # midpoint-corrected departure points
                                    # (reference ice_transport_driver.F90:61)
    monotonicity_check: bool = False  # remap tracer-bounds check w/ abort
                                      # (reference l_monotonicity_check)
    remap_kernel: str = "auto"      # transport engine for 'remap':
                                    # 'auto' (the fused CUDA kernel on a
                                    # CUDA device with f32 state, the plain
                                    # path elsewhere) | 'xla' (plain PyTorch
                                    # path) | 'fused_pallas' (flux-only
                                    # kernel) | 'fused_full'
                                    # (construct+flux+update one-pass)
    # implicit (VP) solver — reference ice_dyn_vp.F90 namelist section
    maxits_nonlin: int = 10
    precond: str = "pgmres"         # 'pgmres' | 'diag' | 'ident'
    dim_fgmres: int = 50
    dim_pgmres: int = 5
    maxits_fgmres: int = 50
    maxits_pgmres: int = 5
    monitor_nonlin: bool = False
    ortho_type: str = "mgs"         # 'mgs' | 'cgs'
    reltol_nonlin: float = 1e-8
    reltol_fgmres: float = 1e-1
    reltol_pgmres: float = 1e-6
    algo_nonlin: str = "picard"     # 'picard' | 'anderson'
    dim_andacc: int = 5
    damping_andacc: float = 0.0
    start_andacc: int = 0
    use_mean_vrel: bool = True

    def __post_init__(self):
        if self.remap_kernel not in ("auto", "xla", "fused_pallas",
                                     "fused_full"):
            raise ValueError(
                f"dynamics.remap_kernel={self.remap_kernel!r}: expected "
                "'auto', 'xla', 'fused_pallas' or 'fused_full'")


@dataclass(frozen=True)
class ShortwaveConfig:
    # reference: shortwave_nml
    shortwave: str = "ccsm3"        # 'ccsm3' | 'dEdd' | 'dEdd_snicar_ad'
    albedo_type: str = "ccsm3"
    albicev: float = 0.78
    albicei: float = 0.36
    albsnowv: float = 0.98
    albsnowi: float = 0.70
    ahmax: float = 0.3
    R_ice: float = 0.0
    R_pnd: float = 0.0
    R_snw: float = 1.5
    dT_mlt: float = 1.5
    rsnw_mlt: float = 1500.0
    kalg: float = 0.6
    modal_aero: bool = False        # modal (internally-mixed) BC-in-snow optics (set_nml.modal)


@dataclass(frozen=True)
class PondConfig:
    # reference: ponds_nml
    hp1: float = 0.01
    hs0: float = 0.03
    hs1: float = 0.03
    dpscale: float = 1.0e-3
    frzpnd: str = "cesm"            # 'cesm' | 'hlid'
    rfracmin: float = 0.15
    rfracmax: float = 1.0
    pndaspect: float = 0.8
    apnd_sl: float = 0.27           # equilibrium pond fraction, sealvl ponds (ug_case_settings.rst:626)
    tscale_pnd_drain: float = 10.0  # macroscopic drainage timescale, days (ug_case_settings.rst:490)


@dataclass(frozen=True)
class SnowConfig:
    # reference: snow_nml
    snwredist: str = "none"
    snwgrain: bool = False
    rsnw_fall: float = 100.0
    rsnw_tmax: float = 1500.0
    rhosnew: float = 100.0
    rhosmin: float = 100.0
    rhosmax: float = 450.0
    windmin: float = 10.0
    drhosdwind: float = 27.3
    snwlvlfac: float = 0.3
    snw_aging_table: str = "exponential"  # 'exponential'|'test'|'snicar'|'file'
    snw_filename: str = ""                # aging-table file (snw_aging_table='file')


@dataclass(frozen=True)
class ZbgcConfig:
    # reference: zbgc_nml (shared/ice_init_column.F90 input_zbgc); the
    # skeletal-layer model parameters follow Jin et al. (2006)
    skl_bgc: bool = False
    tr_bgc_N: bool = True          # algal nitrogen tracer
    tr_bgc_Nit: bool = True        # nitrate tracer
    n_algae: int = 1               # algal classes (diatom/small-phyto/Phaeo)
    tr_bgc_Am: bool = False        # ammonium
    tr_bgc_Sil: bool = False       # silicate
    tr_bgc_DMS: bool = False       # DMSPp + DMSPd + DMS sulfur cycle
    tr_bgc_PON: bool = False       # passive particulate N
    tr_bgc_DON: bool = False       # dissolved organic N
    tr_bgc_Fe: bool = False        # dissolved + particulate iron
    tr_bgc_C: bool = False         # carbon: DOC pools + DIC
    n_doc: int = 2                 # DOC classes (saccharides, lipids[, 3rd])
    n_dic: int = 1                 # DIC classes
    n_fed: int = 1                 # dissolved iron classes (max 2,
    n_fep: int = 1                 # particulate iron classes  icepack_max_fe)
    restore_bgc: bool = False
    bgc_flux_type: str = "Jin2006"
    mu_max: float = 1.44           # max specific growth (1/day)
    K_Nit: float = 1.0             # nitrate half-saturation (mmol/m^3)
    K_Am: float = 0.3              # ammonium half-saturation (mmol/m^3)
    K_Sil: float = 4.0             # silicate half-saturation (mmol/m^3)
    fr_graze: float = 0.1          # grazing rate (1/day)
    mort_pre: float = 0.007        # mortality (1/day)
    fr_resp: float = 0.05          # fraction of loss remineralized
    f_don: float = 0.6             # fraction of losses to DON
    kn_bac: float = 0.03           # DON bacterial remin rate (1/day)
    k_nitrif: float = 0.046        # nitrification rate (1/day)
    t_sk_conv: float = 3.0         # DMSP->DMS conversion time (days)
    t_sk_ox: float = 10.0          # DMS oxidation time (days)
    y_sk_DMS: float = 0.7          # DMS yield from DMSPd
    k_fe_scav: float = 0.01        # iron scavenging rate (1/day)
    pv0: float = 1.0e-2            # piston velocity scale (m/day)
    chlabs_par_half: float = 2.0   # light half-saturation (W/m^2)
    nit_data: float = 10.0         # default ocean nitrate (mmol/m^3)
    amm_data: float = 1.0          # default ocean ammonium (mmol/m^3)
    sil_data: float = 25.0         # default ocean silicate (mmol/m^3)
    dms_data: float = 0.1          # default ocean DMS (mmol S/m^3)
    fed_data: float = 0.5          # default ocean dissolved Fe (umol/m^3)
    don_data: float = 0.0          # default ocean DON (mmol/m^3)
    hum_data: float = 1.0          # default ocean humics (mmol C/m^3)

    # --- vertically-resolved framework (z_tracers / solve_zbgc;
    # reference zbgc_nml, ug_case_settings.rst:802-960) ------------------
    z_tracers: bool = False        # carry tracers on the nblyr bio grid
    solve_zbgc: bool = False       # run the reaction network on that grid
    tr_bgc_hum: bool = False       # passive humic matter tracer
    tr_zaero: bool = False         # vertical aerosols (black carbon, dust)
    n_zaero: int = 0               # up to 6 z-aerosol species
    dEdd_algae: bool = False       # chl feeds the radiative transfer
    # mobility types: <0 purely mobile; [0,1] interpolates stationary-ness
    algaltype_diatoms: float = 0.0
    algaltype_sp: float = 0.0
    algaltype_phaeo: float = 0.0
    nitratetype: float = -1.0
    ammoniumtype: float = 0.0
    silicatetype: float = -1.0
    dmspptype: float = 0.5
    dmspdtype: float = 0.0
    dontype_protein: float = 0.0
    fedtype_1: float = 0.0
    feptype_1: float = 0.5
    humtype: float = 0.0
    zaerotype_bc1: float = -1.0
    zaerotype_bc2: float = -1.0
    zaerotype_dust1: float = -1.0
    zaerotype_dust2: float = -1.0
    zaerotype_dust3: float = -1.0
    zaerotype_dust4: float = -1.0
    tau_min: float = 3600.0        # rapid mobile<->stationary exchange (s)
    tau_max: float = 604800.0      # slow exchange (s)
    grid_o: float = 0.006          # bottom molecular-sublayer scale (m)
    grid_o_t: float = 0.006        # top exchange scale (m)
    l_sk: float = 2.0              # characteristic diffusive scale (m)
    initbio_frac: float = 1.0      # new-ice scavenging of ocean tracer
    frazil_scav: float = 0.8       # frazil-formation scavenging factor
    max_loss: float = 0.9          # max fractional uptake per step
    # per-algal-class parameters (diatoms / small plankton / Phaeocystis)
    mu_max_diatoms: float = 1.44   # max growth (1/day)
    mu_max_sp: float = 0.41
    mu_max_phaeo: float = 0.63
    grow_Tdep_diatoms: float = 0.063   # growth T-dependence (1/degC)
    grow_Tdep_sp: float = 0.063
    grow_Tdep_phaeo: float = 0.063
    mort_pre_diatoms: float = 0.007    # mortality (1/day)
    mort_pre_sp: float = 0.007
    mort_pre_phaeo: float = 0.007
    mort_Tdep_diatoms: float = 0.03    # mortality T-dependence (1/degC)
    mort_Tdep_sp: float = 0.03
    mort_Tdep_phaeo: float = 0.03
    K_Nit_diatoms: float = 1.0     # nitrate half-saturation (mmol/m^3)
    K_Nit_sp: float = 1.0
    K_Nit_phaeo: float = 1.0
    K_Am_diatoms: float = 0.3      # ammonium half-saturation (mmol/m^3)
    K_Am_sp: float = 0.3
    K_Am_phaeo: float = 0.3
    K_Sil_diatoms: float = 4.0     # silicate half-saturation (mmol/m^3)
    K_Sil_sp: float = 0.0
    K_Sil_phaeo: float = 0.0
    alpha2max_low_diatoms: float = 0.3   # light limitation (1/(W/m^2))
    alpha2max_low_sp: float = 0.2
    alpha2max_low_phaeo: float = 0.17
    beta2max_diatoms: float = 0.001      # light inhibition (1/(W/m^2))
    beta2max_sp: float = 0.001
    beta2max_phaeo: float = 0.04
    ratio_Si2N_diatoms: float = 1.8      # Si:N uptake (mol/mol)
    ratio_Si2N_sp: float = 0.0
    ratio_Si2N_phaeo: float = 0.0
    ratio_S2N_diatoms: float = 0.03      # S:N (mol/mol)
    ratio_S2N_sp: float = 0.03
    ratio_S2N_phaeo: float = 0.03
    ratio_chl2N_diatoms: float = 2.1     # chl:N (mg/mmol)
    ratio_chl2N_sp: float = 1.1
    ratio_chl2N_phaeo: float = 0.84
    chlabs_diatoms: float = 0.03   # chl absorption (1/m per mg chl/m^3)
    chlabs_sp: float = 0.01
    chlabs_phaeo: float = 0.05
    fr_graze_diatoms: float = 0.19       # fraction grazed (1/day scale)
    fr_graze_sp: float = 0.19
    fr_graze_phaeo: float = 0.19
    fr_graze_s: float = 0.5        # grazing fraction spilled
    fr_graze_e: float = 0.5        # assimilation fraction excreted
    fr_mort2min: float = 0.9       # mortality fraction to ammonium
    f_don_protein: float = 0.6     # spilled grazing fraction to DON
    f_don_Am_protein: float = 1.0  # remineralized DON fraction to NH4
    kn_bac_protein: float = 0.2    # bacterial DON degradation (1/day)
    t_iron_conv: float = 3065.0    # pFe->dFe desorption time (days)
    # carbon chain (tr_bgc_C; reference zbgc_nml DOC/DIC surface)
    ratio_C2N_diatoms: float = 7.0     # algal C:N (mol/mol)
    ratio_C2N_sp: float = 7.0
    ratio_C2N_phaeo: float = 5.0
    ratio_C2N_proteins: float = 5.0    # C:N of the DON pool
    f_doc_s: float = 0.4           # spilled-carbon fraction to saccharides
    f_doc_l: float = 0.4           # ... to lipids (remainder exits as DIC)
    kn_bac_s: float = 0.03         # bacterial DOC degradation (1/day)
    kn_bac_l: float = 0.03
    fr_resp_s: float = 0.75        # respired fraction of DOC degradation
    doctype_s: float = 0.5         # mobility types
    doctype_l: float = 0.5
    dictype_1: float = -1.0
    doc_data: float = 16.2         # default ocean DOC (mmol C/m^3)
    dic_data: float = 1950.0       # default ocean DIC (mmol C/m^3)


@dataclass(frozen=True)
class ForcingConfig:
    # reference: forcing_nml
    atmbndy: str = "similarity"     # 'similarity' | 'constant' | 'mixed'
    atm_data_type: str = "box2001"  # 'ncar'|'jra55'|'box2001'|'uniform_east'|...|'calm'
    ocn_data_type: str = "default"
    bgc_data_type: str = "default"
    atm_data_dir: str = ""
    ocn_data_dir: str = ""
    precip_units: str = "mks"
    fyear_init: int = 2005
    ycycle: int = 1
    calc_strair: bool = True
    rotate_wind: bool = True        # rotate file-forcing vectors geo->grid
    highfreq: bool = False
    natmiter: int = 5               # iterations for atm boundary layer stability
    atmiter_conv: float = 0.0
    calc_Tsfc: bool = True
    default_season: str = "winter"
    oceanmixed_ice: bool = True
    # orbital-parameter mode (reference coupler attribute surface,
    # ice_comp_nuopc.F90:87-96 orb_mode/orb_iyear/orb_eccen/...)
    orb_mode: str = "fixed_year"    # 'fixed_year' | 'fixed_parameters'
    orb_iyear: int = 2000
    orb_eccen: float = 0.016708634  # used by 'fixed_parameters' (paleo)
    orb_obliq: float = 23.4392911
    orb_mvelp: float = 102.93735
    wave_spec_type: str = "none"    # 'none'|'constant'|'profile'|'random'
                                    # |'file' (wave-model spectrum dataset)
    wave_spec_file: str = ""        # monthly 25-frequency E(f) file
                                    # (reference get_wave_spec/wave_spec_file)
    restore_ice: bool = False
    restore_ocn: bool = False
    trestore: int = 90
    ice_data_file: str = ""         # boundary-restore snapshot (restart fmt)
    update_ocn_f: bool = False
    l_mpond_fresh: bool = False
    ustar_min: float = 0.005
    emissivity: float = 0.985
    fbot_xfer_type: str = "constant"
    formdrag: bool = False
    iceruf: float = 0.0005


@dataclass(frozen=True)
class Config:
    """Top-level model configuration (analogue of the full `ice_in` file)."""

    setup: SetupConfig = field(default_factory=SetupConfig)
    grid: GridConfig = field(default_factory=GridConfig)
    domain: DomainConfig = field(default_factory=DomainConfig)
    tracers: TracerConfig = field(default_factory=TracerConfig)
    thermo: ThermoConfig = field(default_factory=ThermoConfig)
    dynamics: DynamicsConfig = field(default_factory=DynamicsConfig)
    shortwave: ShortwaveConfig = field(default_factory=ShortwaveConfig)
    ponds: PondConfig = field(default_factory=PondConfig)
    snow: SnowConfig = field(default_factory=SnowConfig)
    zbgc: ZbgcConfig = field(default_factory=ZbgcConfig)
    forcing: ForcingConfig = field(default_factory=ForcingConfig)
    dtype: str = "float32"          # working dtype for state ('float32'|'float64')

    # -- helpers ------------------------------------------------------------
    @property
    def np_dtype(self) -> torch.dtype:
        return {"float32": torch.float32,
                "float64": torch.float64}[self.dtype]

    def replace(self, **groups) -> "Config":
        """Replace whole groups: cfg.replace(dynamics=cfg.dynamics.replace(...))."""
        return _replace(self, **groups)

    def with_overrides(self, **flat) -> "Config":
        """Apply dotted overrides: cfg.with_overrides(**{'dynamics.ndte': 240})."""
        cfg = self
        grouped: dict[str, dict[str, Any]] = {}
        for key, val in flat.items():
            group, _, name = key.partition(".")
            if not name:
                cfg = _replace(cfg, **{group: val})
            else:
                grouped.setdefault(group, {})[name] = val
        for group, kv in grouped.items():
            cfg = _replace(cfg, **{group: _replace(getattr(cfg, group), **kv)})
        return cfg


# Attach a generic .replace to every group dataclass for ergonomic updates.
for _cls in (SetupConfig, GridConfig, DomainConfig, TracerConfig, ThermoConfig,
             DynamicsConfig, ShortwaveConfig, PondConfig, SnowConfig,
             ZbgcConfig, ForcingConfig):
    _cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)  # type: ignore


# ---------------------------------------------------------------------------
# Canonical configurations (analogue of cice.setup option fragments)
# ---------------------------------------------------------------------------

def box2001_config(nx: int = 80, ny: int = 80) -> Config:
    """Idealized 80x80 box with analytic forcing (reference set_nml.box2001)."""
    cfg = Config()
    cfg = cfg.with_overrides(**{
        "grid.nx_global": nx, "grid.ny_global": ny,
        "grid.grid_format": "rect", "grid.kmt_type": "default",
        "grid.ew_boundary_type": "cyclic", "grid.ns_boundary_type": "open",
        "setup.dt": 3600.0,
        "forcing.atm_data_type": "box2001",
        "forcing.ocn_data_type": "box2001",
        "dynamics.advection": "upwind",
        "dynamics.coriolis": "constant",
    })
    return cfg


def gx3_config() -> Config:
    """gx3 (3-degree displaced-pole, 100x116) standalone configuration."""
    cfg = Config()
    cfg = cfg.with_overrides(**{
        "grid.nx_global": 100, "grid.ny_global": 116,
        "grid.grid_format": "displaced_pole",
        "grid.ew_boundary_type": "cyclic", "grid.ns_boundary_type": "open",
        "setup.dt": 3600.0,
        "forcing.atm_data_type": "ncar",
    })
    return cfg


def gx1pop_step(nx: int = 320, ny: int = 384,
                remap_kernel: str = "fused_pallas") -> Config:
    """The full coupled step on the format-true gx1 displaced-pole POP grid
    (the bench.py:95-106 overrides: 320x384, E-W cyclic, ndte=120, latitude
    Coriolis) with the fused EVP kernel and everything else at the Config()
    defaults: BL99 thermodynamics, linear ITD remap, ccsm3 shortwave, the
    similarity boundary layer with calc_strair, age/FY/level-ice/level-pond
    tracers (NT=25), ridging, the slab ocean, box2001 winds, f32.
    remap_kernel='fused_pallas' runs the flux-only transport kernel,
    'auto' the one-pass transport kernel (on a CUDA device), 'xla' the
    plain path. Smaller (nx, ny) give the same grid construction at test
    size; the grid files are written under io.fixtures.fixtures_root()."""
    from .io.fixtures import ensure_displaced_pole_grid
    fx = ensure_displaced_pole_grid(nx, ny)
    return Config().with_overrides(**{
        "grid.nx_global": nx, "grid.ny_global": ny,
        "grid.grid_format": "pop_bin", "grid.grid_type": "displaced_pole",
        "grid.grid_file": fx["grid"], "grid.kmt_file": fx["kmt"],
        "grid.ew_boundary_type": "cyclic",
        "dynamics.ndte": 120, "dynamics.coriolis": "latitude",
        "dynamics.evp_algorithm": "fused_pallas",
        "dynamics.remap_kernel": remap_kernel})


def gx1pop_dyn(nx: int = 320, ny: int = 384) -> Config:
    """The dynamics-transport supercycle alone on the grid of
    `gx1pop_step`: remap_kernel='auto', ridging off and the box2001 wind
    stress passed through (calc_strair=False); driven by
    Model.run_dynamics."""
    return gx1pop_step(nx, ny, remap_kernel="auto").with_overrides(**{
        "dynamics.kridge": -1,
        "forcing.calc_strair": False})
