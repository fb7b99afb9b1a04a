"""Atmosphere-ice boundary layer: turbulent flux transfer coefficients
(PyTorch port of cice_tpu/columns/atmo.py).

The CCSM Monin-Obukhov similarity scheme (Kauffman & Large 2002;
`atmbndy='similarity'`) and the constant-coefficient alternative
(`atmbndy='constant'`). Dense over the grid; the stability iteration runs a
fixed `natmiter` count with no data-dependent branching.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import constants as cst


class AtmoCoeffs(NamedTuple):
    shcoef: torch.Tensor   # sensible-heat transfer coefficient (W m-2 K-1)
    lhcoef: torch.Tensor   # latent-heat transfer coefficient (W m-2/(kg/kg))
    strx: torch.Tensor     # wind stress on ice, x (N/m^2)
    stry: torch.Tensor     # wind stress on ice, y (N/m^2)
    Tref: Optional[torch.Tensor] = None   # 2 m air temperature (K)
    Qref: Optional[torch.Tensor] = None   # 2 m specific humidity (kg/kg)
    Uref: Optional[torch.Tensor] = None   # 10 m wind speed (m/s)


RHOA_MIN = 1e-8    # floor of the air density in q_sat (kg/m^3)
TSFK_MIN = 150.0   # floor of the surface temperature in q_sat (K)


def saturated_specific_humidity_ice(TsfK, rhoa):
    """q_sat over ice (kg/kg). TsfK floored at TSFK_MIN: a negative
    absolute temperature (possible only from degenerate unconverged
    columns) would flip the exp() to +inf."""
    return (cst.qqqice / torch.clamp(rhoa, min=RHOA_MIN)) * \
        torch.exp(-cst.TTTice / torch.clamp(TsfK, min=TSFK_MIN))


def saturated_specific_humidity_ocn(TsfK, rhoa):
    return (cst.qqqocn / torch.clamp(rhoa, min=RHOA_MIN)) * \
        torch.exp(-cst.TTTocn / torch.clamp(TsfK, min=TSFK_MIN))


def _psimu(xd):
    """Unstable momentum stability function."""
    return torch.log((1.0 + xd * (2.0 + xd)) * (1.0 + xd * xd) / 8.0) \
        - 2.0 * torch.atan(xd) + 1.571


def _psixu(xd):
    """Unstable scalar stability function."""
    return 2.0 * torch.log((1.0 + xd * xd) / 2.0)


def atmo_boundary_layer(Tsf, potT, uatm, vatm, wind, zlvl, Qa, rhoa,
                        *, natmiter: int = 5, over: str = "ice",
                        iceruf: float = cst.iceruf,
                        Cdn_atm=None, atmiter_conv: float = 0.0
                        ) -> AtmoCoeffs:
    """Monin-Obukhov similarity transfer coefficients over ice or ocean.

    Tsf in degC; potT (K) potential temperature at zlvl; Qa specific
    humidity; returns coefficients such that
      fsens = shcoef * (potT - TsfK),   flat = lhcoef * (Qa - qsfc).
    """
    TsfK = Tsf + cst.Tffresh
    if over == "ice":
        qsfc = saturated_specific_humidity_ice(TsfK, rhoa)
        lheat = cst.Lsub
        zrf = iceruf
    else:
        qsfc = saturated_specific_humidity_ocn(TsfK, rhoa)
        lheat = cst.Lvap
        zrf = 0.0005

    vmag = torch.clamp(wind, min=1.0)      # umin wind speed floor (m/s)
    thva = potT * (1.0 + cst.zvir * Qa)    # virtual potential temperature
    delt = potT - TsfK
    delq = Qa - qsfc

    # neutral coefficients; with form drag the momentum coefficient comes
    # from the Tsamados decomposition (sqrt(Cdn) = u*/U at zref); heat and
    # moisture stay skin-scale
    rdn0 = cst.vonkar / math.log(cst.zref / zrf)
    if Cdn_atm is not None and over == "ice":
        rdn = torch.sqrt(torch.clamp(Cdn_atm, min=1e-6))
    else:
        rdn = rdn0
    rhn = ren = rdn0

    ustar = rdn * vmag
    tstar = rhn * delt
    qstar = ren * delq

    alz = torch.log(zlvl / cst.zref)
    cp = cst.cp_air * (1.0 + cst.cp_wv * Qa)

    rd = rh = re = None
    # atmiter_conv: freeze converged points (|d ustar| below threshold)
    active = torch.ones_like(vmag, dtype=torch.bool)
    for _ in range(natmiter):
        ustar_prev = ustar
        hol = (cst.vonkar * cst.gravit * zlvl *
               (tstar / thva + qstar / (1.0 / cst.zvir + Qa)) /
               torch.clamp(ustar * ustar, min=1e-12))
        hol = torch.clamp(hol, -10.0, 10.0)
        stable = 0.5 * (1.0 + torch.sign(hol))
        xqq = torch.clamp(torch.sqrt(torch.abs(1.0 - 16.0 * hol)), min=1.0)
        xqq = torch.sqrt(xqq)
        psimh = -5.0 * hol * stable + (1.0 - stable) * _psimu(xqq)
        psixh = -5.0 * hol * stable + (1.0 - stable) * _psixu(xqq)
        rd_n = rdn / (1.0 + rdn / cst.vonkar * (alz - psimh))
        rh_n = rhn / (1.0 + rhn / cst.vonkar * (alz - psixh))
        re_n = ren / (1.0 + ren / cst.vonkar * (alz - psixh))
        if atmiter_conv > 0.0 and rd is not None:
            rd = torch.where(active, rd_n, rd)
            rh = torch.where(active, rh_n, rh)
            re = torch.where(active, re_n, re)
        else:
            rd, rh, re = rd_n, rh_n, re_n
        ustar = rd * vmag
        tstar = rh * delt
        qstar = re * delq
        if atmiter_conv > 0.0:
            active = active & (torch.abs(ustar - ustar_prev) > atmiter_conv)

    # |stress| = rhoa*ustar^2 along the wind direction: the coefficient
    # multiplies the wind components, not |U| again
    tau = rhoa * ustar * rd
    strx = tau * uatm
    stry = tau * vatm
    shcoef = rhoa * ustar * cp * rh
    lhcoef = rhoa * ustar * lheat * re

    # reference-height diagnostics: similarity profile at 2 m / 10 m
    zTrf = 2.0
    hol2 = hol * zTrf / zlvl
    xd2 = torch.sqrt(torch.clamp(
        torch.sqrt(torch.abs(1.0 - 16.0 * hol2)), min=1.0))
    psix2 = -5.0 * hol2 * stable + (1.0 - stable) * _psixu(xd2)
    prof = torch.log(zlvl / zTrf) - psixh + psix2
    Tref = potT - delt * (rh / cst.vonkar) * prof - 0.01 * zTrf
    Qref = Qa - delq * (re / cst.vonkar) * prof
    Uref = vmag * rd / (torch.clamp(rdn, min=1e-8)
                        if isinstance(rdn, torch.Tensor) else max(rdn, 1e-8))
    return AtmoCoeffs(shcoef=shcoef, lhcoef=lhcoef, strx=strx, stry=stry,
                      Tref=Tref, Qref=Qref, Uref=Uref)


def atmo_boundary_const(Tsf, uatm, vatm, wind, rhoa, Qa,
                        over: str = "ice") -> AtmoCoeffs:
    """Constant-coefficient scheme (`atmbndy='constant'`)."""
    lheat = cst.Lsub if over == "ice" else cst.Lvap
    tau = rhoa * 0.0012 * wind
    shcoef = (1.20e-3) * cst.cp_air * rhoa * wind
    lhcoef = (1.50e-3) * lheat * rhoa * wind
    return AtmoCoeffs(shcoef=shcoef, lhcoef=lhcoef,
                      strx=tau * uatm, stry=tau * vatm)


def surface_fluxes(Tsf, shcoef, lhcoef, potT, Qa, rhoa, flw, fswsfc,
                   emissivity: float = cst.emissivity):
    """Surface energy fluxes and their Tsf derivative at temperature Tsf.

    Downward positive. Returns (fsurf_net, dfsurf_dT, fsens, flat, flwout);
    fsurf_net includes absorbed shortwave at the surface, net longwave and
    the turbulent fluxes.
    """
    TsfK = Tsf + cst.Tffresh
    qsfc = saturated_specific_humidity_ice(TsfK, rhoa)
    dqsfc_dT = qsfc * cst.TTTice / (TsfK * TsfK)

    fsens = shcoef * (potT - TsfK)
    dfsens_dT = -shcoef
    flat = lhcoef * (Qa - qsfc)
    dflat_dT = -lhcoef * dqsfc_dT
    flwout = -emissivity * cst.stefan_boltzmann * TsfK ** 4
    dflwout_dT = -4.0 * emissivity * cst.stefan_boltzmann * TsfK ** 3
    flwdabs = emissivity * flw

    fsurf = fswsfc + flwdabs + flwout + fsens + flat
    dfsurf = dflwout_dT + dfsens_dT + dflat_dT
    return fsurf, dfsurf, fsens, flat, flwout
