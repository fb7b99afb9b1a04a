"""Orbital mechanics for the solar zenith angle (a frozen copy of the
program's columns/orbit.py, a PyTorch port of cice_tpu/columns/orbit.py;
reference icepack_init_orbit / CESM shr_orb_mod).

`OrbitalParams` holds (eccen, obliq, mvelp); `solar_declination` is the
shr_orb_decl algorithm and `compute_coszen` the instantaneous or
daylight-weighted daily-mean cosine of the solar zenith angle. The calendar
day is a Python float, so the declination and the eccentricity factor are
Python floats (f64), as the JAX package's weak-typed scalars are.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

DAYS_PER_YEAR = 365.0
VE_DAY = 80.5          # calendar day of the vernal equinox (shr_orb_mod)


@dataclass(frozen=True)
class OrbitalParams:
    eccen: float = 0.0167          # orbital eccentricity
    obliq: float = 23.4392991      # obliquity (degrees)
    mvelp: float = 102.932         # longitude of perihelion (deg)

    @property
    def obliqr(self) -> float:
        return math.radians(self.obliq)

    @property
    def mvelpp(self) -> float:
        """Longitude of perihelion plus pi (radians), as shr_orb uses it."""
        return math.radians(self.mvelp) + math.pi

    @property
    def lambm0(self) -> float:
        """Mean longitude of perihelion at the vernal equinox (radians)."""
        e = self.eccen
        beta = math.sqrt(1.0 - e * e)
        m = self.mvelpp
        return -2.0 * (
            (e / 2.0 + e ** 3 / 8.0) * (1.0 + beta) * math.sin(m)
            - (e * e / 4.0) * (0.5 + beta) * math.sin(2.0 * m)
            + (e ** 3 / 8.0) * (1.0 / 3.0 + beta) * math.sin(3.0 * m))


def orb_params(iyear: int) -> OrbitalParams:
    """Orbital parameters for a model year from the secular polynomial
    expansions (IAU obliquity, Simon et al. 1994 eccentricity and
    perihelion); paleo runs pass explicit parameters instead."""
    T = (iyear - 2000.0) / 100.0          # Julian centuries from J2000
    eps = (84381.448 - 46.8150 * T - 0.00059 * T * T
           + 0.001813 * T ** 3) / 3600.0
    eccen = 0.016708634 - 0.000042037 * T - 0.0000001267 * T * T
    mvelp = (102.93735 + 1.71946 * T + 0.00046 * T * T) % 360.0
    return OrbitalParams(eccen=float(eccen), obliq=float(eps),
                         mvelp=float(mvelp))


def solar_declination(calday: float, params: OrbitalParams = OrbitalParams()):
    """(declination [rad], eccentricity factor [-]) for a calendar day
    (shr_orb_decl)."""
    e = params.eccen
    lambm = params.lambm0 + (calday - VE_DAY) * 2.0 * math.pi / DAYS_PER_YEAR
    lmm = lambm - params.mvelpp
    sinl = math.sin(lmm)
    lamb = lambm + e * (2.0 * sinl + e * (1.25 * math.sin(2.0 * lmm)
                                          + e * (13.0 / 12.0)
                                          * math.sin(3.0 * lmm)))
    invrho = (1.0 + e * math.cos(lamb - params.mvelpp)) / (1.0 - e * e)
    decl = math.asin(math.sin(params.obliqr) * math.sin(lamb))
    return decl, invrho * invrho


def compute_coszen(tlat: torch.Tensor, tlon: torch.Tensor, calday: float,
                   params: OrbitalParams = OrbitalParams(), *,
                   daily_mean: bool = False):
    """(cosine of the solar zenith angle, eccentricity factor): the
    daylight-weighted daily mean, or the instantaneous value from the hour
    angle. tlat/tlon in radians; calday the fractional day of the year."""
    decl, eccf = solar_declination(calday, params)
    if daily_mean:
        cosH = torch.clamp(-torch.tan(tlat) * math.tan(decl), -1.0, 1.0)
        H = torch.arccos(cosH)             # half-day hour angle
        mean = (H * torch.sin(tlat) * math.sin(decl)
                + torch.cos(tlat) * math.cos(decl) * torch.sin(H)) / math.pi
        return torch.clamp(mean, min=0.0), eccf
    frac = calday - math.floor(calday)
    hour_angle = 2.0 * math.pi * frac + tlon - math.pi
    cosz = (torch.sin(tlat) * math.sin(decl)
            + torch.cos(tlat) * math.cos(decl) * torch.cos(hour_angle))
    return torch.clamp(cosz, min=0.0), eccf
