"""Forcing fields exchanged with atmosphere and ocean (PyTorch port of the
`Forcing` part of cice_tpu/model/flux.py). `FluxOut` comes with the full
model step (ROADMAP: slice 2)."""

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
