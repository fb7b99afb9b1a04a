"""Flux fields exchanged with atmosphere and ocean (PyTorch port of
cice_tpu/model/flux.py): `Forcing` goes in, `FluxOut` comes out of a step."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .. import constants as cst

#: every tensor field of Forcing, in declaration order
FORCING_FIELDS = ("uatm", "vatm", "wind", "strax", "stray", "potT", "Tair",
                  "Qa", "rhoa", "flw", "swvdr", "swvdf", "swidr", "swidf",
                  "frain", "fsnow", "zlvl", "coszen", "wave_hs", "wave_Tp",
                  "wave_spectrum", "uocn", "vocn", "sss", "sst_data", "Tf",
                  "qdp", "hmix", "ss_tltx", "ss_tlty", "yday", "pbot",
                  "faero_atm", "fiso_atm")


@dataclass(frozen=True)
class Forcing:
    """Per-step atmosphere & ocean forcing state (T grid unless noted)."""
    uatm: torch.Tensor      # wind velocity (m/s)
    vatm: torch.Tensor
    wind: torch.Tensor      # wind speed (m/s)
    strax: torch.Tensor     # wind stress on ice if calc_strair=False (N/m^2)
    stray: torch.Tensor
    potT: torch.Tensor      # air potential temperature (K)
    Tair: torch.Tensor      # air temperature (K)
    Qa: torch.Tensor        # specific humidity (kg/kg)
    rhoa: torch.Tensor      # air density (kg/m^3)
    flw: torch.Tensor       # incoming longwave (W/m^2)
    swvdr: torch.Tensor     # incoming shortwave bands (W/m^2)
    swvdf: torch.Tensor
    swidr: torch.Tensor
    swidf: torch.Tensor
    frain: torch.Tensor     # rain rate (kg/m^2/s)
    fsnow: torch.Tensor     # snow rate (kg/m^2/s)
    zlvl: torch.Tensor      # atm level height (m)
    coszen: torch.Tensor    # cosine of solar zenith angle
    wave_hs: torch.Tensor   # significant wave height (m)
    wave_Tp: torch.Tensor   # peak wave period (s)
    wave_spectrum: torch.Tensor   # (NFREQ, ny, nx) E(f) (m^2/Hz)
    uocn: torch.Tensor      # ocean current (m/s)
    vocn: torch.Tensor
    sss: torch.Tensor       # sea surface salinity (psu)
    sst_data: torch.Tensor  # climatological/restoring SST (degC)
    Tf: torch.Tensor        # freezing temperature (degC)
    qdp: torch.Tensor       # deep ocean heat flux (W/m^2)
    hmix: torch.Tensor      # mixed layer depth (m)
    ss_tltx: torch.Tensor   # sea surface slope (m/m)
    ss_tlty: torch.Tensor
    yday: torch.Tensor      # day of year (0-d tensor)
    pbot: torch.Tensor      # surface air pressure (Pa)
    faero_atm: torch.Tensor  # (n_aero, ny, nx); empty = defaults
    fiso_atm: torch.Tensor   # (n_iso, ny, nx); empty = defaults

    def replace(self, **kw) -> "Forcing":
        return dataclasses.replace(self, **kw)


def zeros_forcing(shape, dtype=torch.float32, device="cuda") -> Forcing:
    kw = dict(dtype=dtype, device=device)
    z = lambda v=0.0: torch.full(tuple(shape), v, **kw)
    return Forcing(
        uatm=z(), vatm=z(), wind=z(), strax=z(), stray=z(),
        potT=z(253.0), Tair=z(253.0), Qa=z(0.0006), rhoa=z(cst.rhoa_ref),
        flw=z(180.0), swvdr=z(), swvdf=z(), swidr=z(), swidf=z(),
        frain=z(), fsnow=z(), zlvl=z(10.0), coszen=z(0.5),
        wave_hs=z(), wave_Tp=z(8.0),
        wave_spectrum=torch.zeros((25,) + tuple(shape), **kw),
        uocn=z(), vocn=z(), sss=z(34.0), sst_data=z(-1.8),
        Tf=z(-1.8), qdp=z(), hmix=z(20.0), ss_tltx=z(), ss_tlty=z(),
        yday=torch.zeros((), **kw),
        pbot=z(101325.0),
        faero_atm=torch.zeros((0,) + tuple(shape), **kw),
        fiso_atm=torch.zeros((0,) + tuple(shape), **kw),
    )


@dataclass(frozen=True)
class FluxOut:
    """Cell-mean output fluxes & diagnostics of one step (coupler fields +
    history sources)."""
    # atm
    fsens: torch.Tensor
    flat: torch.Tensor
    flwout: torch.Tensor
    evap: torch.Tensor
    fswabs: torch.Tensor
    strairx: torch.Tensor   # wind stress on ice (N/m^2)
    strairy: torch.Tensor
    # ocn
    fhocn: torch.Tensor     # net heat to ocean (W/m^2)
    fresh: torch.Tensor     # fresh water to ocean (kg/m^2/s)
    fsalt: torch.Tensor     # salt to ocean (kg/m^2/s)
    fswthru: torch.Tensor   # SW through ice to ocean (W/m^2)
    strocnx: torch.Tensor   # ice-ocean stress at U (N/m^2)
    strocny: torch.Tensor
    # mass-budget diagnostics (m/step)
    meltt: torch.Tensor
    meltb: torch.Tensor
    melts: torch.Tensor
    meltl: torch.Tensor
    congel: torch.Tensor
    frazil: torch.Tensor
    snoice: torch.Tensor
    # radiation
    alvdr: torch.Tensor
    alvdf: torch.Tensor
    alidr: torch.Tensor
    alidf: torch.Tensor
    albice: torch.Tensor
    fsurf: torch.Tensor     # net surface flux diagnostic
    fcondtop: torch.Tensor
    # dynamics diagnostics
    divu: torch.Tensor      # velocity divergence (1/s)
    shear: torch.Tensor     # shear deformation rate
    Delta: torch.Tensor     # total deformation
    strintx: torch.Tensor   # internal stress divergence at U (N/m^2)
    strinty: torch.Tensor
    taubx: torch.Tensor     # seabed (basal) stress (N/m^2)
    tauby: torch.Tensor
    strength: torch.Tensor  # ice compressive strength (N/m)
    # mechanical redistribution rates
    dardg1dt: torch.Tensor  # area rate ridged
    dardg2dt: torch.Tensor  # area rate of new ridges
    dvirdgdt: torch.Tensor  # volume rate ridged
    opening: torch.Tensor   # lead opening rate
    # state tendencies split thermo vs dynamics
    daidtt: torch.Tensor    # area tendency, thermodynamics (1/s)
    dvidtt: torch.Tensor    # volume tendency, thermodynamics (m/s)
    daidtd: torch.Tensor    # area tendency, dynamics (1/s)
    dvidtd: torch.Tensor    # volume tendency, dynamics (m/s)
    # reference-height diagnostics
    Tref: torch.Tensor      # 2 m air temperature (K)
    Qref: torch.Tensor      # 2 m specific humidity (kg/kg)
    Uref: torch.Tensor      # 10 m wind speed (m/s)
    # extended diagnostics
    fbot: torch.Tensor      # ocean heat used at the ice bottom (W/m^2, cell)
    fcondbot: torch.Tensor  # conductive flux at the ice bottom (W/m^2)
    fswint: torch.Tensor    # SW absorbed in the ice interior (W/m^2)
    fpond: torch.Tensor     # pond freshwater retention flux (kg/m^2/s)
    apeff: torch.Tensor     # radiatively-effective pond fraction (cell mean)
    meltsliq: torch.Tensor  # snow liquid runoff (kg/m^2, per step)
    snowfrac: torch.Tensor  # snow-covered fraction of the cell
    albsno: torch.Tensor    # broadband albedo contribution, snow surface
    albpnd: torch.Tensor    # broadband albedo contribution, ponds
    dvsdtd: torch.Tensor    # snow volume tendency, dynamics (m/s)
    dvsdtt: torch.Tensor    # snow volume tendency, thermo (m/s)
    dagedtt: torch.Tensor   # mean ice-age tendency, thermo (s/s)
    dagedtd: torch.Tensor   # mean ice-age tendency, dynamics (s/s)
    # pond water budget terms, cell mean (m of water per step)
    dpnd_initial: torch.Tensor
    dpnd_expon: torch.Tensor
    dpnd_freebd: torch.Tensor
    dpnd_dlid: torch.Tensor
    # per-category / extra history planes, pre-weighted by category area
    ncat_fluxes: dict
    # transport safety-rail scalars (remap oob/neg-mass/monotonicity flags
    # and conservation errors)
    transport_checks: dict

    def replace(self, **kw) -> "FluxOut":
        return dataclasses.replace(self, **kw)


#: every (ny, nx) tensor field of FluxOut, in declaration order
FLUXOUT_FIELDS = tuple(
    f.name for f in dataclasses.fields(FluxOut)
    if f.name not in ("ncat_fluxes", "transport_checks"))


def zeros_fluxout(shape, dtype=torch.float32, device="cuda") -> FluxOut:
    z = lambda: torch.zeros(tuple(shape), dtype=dtype, device=device)
    return FluxOut(ncat_fluxes={}, transport_checks={},
                   **{n: z() for n in FLUXOUT_FIELDS})
