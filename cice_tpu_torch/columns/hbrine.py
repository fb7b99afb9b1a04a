"""Brine height tracer (tr_brine; PyTorch port of cice_tpu/columns/
hbrine.py; reference update_hbrine through icepack_intfc, tracer `fbri`,
restart group restart_hbrine, diagnostics hbrine_diags).

The brine surface `hbr` (measured upward from the ice bottom) is carried as
the ratio tracer `fbri = hbr/hin` and evolves by (Jeffery, Hunke & Elliott
2011): a growth/melt pre-adjustment (bottom congelation adds to hbr, bottom
melt removes ice below it, top melt adds a meltwater fraction), then a
Darcy relaxation toward the hydrostatic sea level
`h_ocn = (rhoi*hin + rhos*hsn) / rhow` through the permeability
`perm = 3e-8 * phi_min^3` of the least liquid layer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as cst
from .mushy import liquid_fraction, temperature_mush

GRAVIT = 9.80665        # m/s^2
VISC_DYN = 1.79e-3      # dynamic viscosity of brine (kg/m/s)
PERM_SCALE = 3.0e-8     # permeability prefactor (m^2), Golden et al. 2007
PHI_SNOW = 0.5          # snow porosity seen by flooding brine
FBRI_INIT = 1.0         # new ice forms fully brine-filled (fbri = 1)
FBRI_MIN = 0.1
FBRI_MAX = 1.2          # brine may flood above the ice surface into snow


class HbrineOut(NamedTuple):
    fbri: torch.Tensor      # updated brine-height fraction (ncat, ny, nx)
    hbri: torch.Tensor      # cell-mean brine height (ny, nx)
    darcy_V: torch.Tensor   # Darcy velocity, +up (ncat, ny, nx) (m/s)


def update_hbrine(dt, *, aicen, vicen, vsnon, fbri, qice, sice,
                  meltb, meltt, congel, frazil_n=None):
    """Advance the brine-height tracer one step. qice/sice: (ncat, nilyr,
    ny, nx); meltb/meltt/congel: per-category thickness changes this step
    (m, >= 0)."""
    mask = aicen > cst.puny
    am = torch.clamp(aicen, min=cst.puny)
    hin = torch.where(mask, vicen / am, 0.0)
    hsn = torch.where(mask, vsnon / am, 0.0)

    hbr = torch.clamp(fbri, FBRI_MIN, FBRI_MAX) * hin
    # bottom growth raises the brine surface with the new porous ice;
    # bottom melt removes ice below it; top melt percolates a fraction
    hbr = hbr + congel - meltb + 0.5 * meltt
    if frazil_n is not None:
        hbr = hbr + frazil_n

    # permeability of the least liquid layer (the mushy liquidus of each
    # layer's enthalpy and bulk salinity)
    phi_min = None
    for k in range(qice.shape[1]):
        Sk = torch.clamp(sice[:, k], min=cst.puny)
        Tk = temperature_mush(qice[:, k], Sk)
        phik = torch.clamp(liquid_fraction(torch.clamp(Tk, max=-cst.puny),
                                           Sk), 0.0, 1.0)
        phi_min = phik if phi_min is None else torch.minimum(phi_min, phik)
    perm = PERM_SCALE * (phi_min * (phi_min * phi_min))

    # Darcy relaxation toward hydrostatic sea level, implicit in the gap:
    # dhbr/dt = -K (hbr - h_ocn), K = perm*rhow*g/(mu*hbr)
    h_ocn = (cst.rhoi * hin + cst.rhos * hsn) / cst.rhow
    hbr_safe = torch.clamp(hbr, min=cst.puny)
    darcy_V = -perm * cst.rhow * GRAVIT * (hbr - h_ocn) / (
        VISC_DYN * hbr_safe)
    K = perm * cst.rhow * GRAVIT / (VISC_DYN * hbr_safe)
    hbr = h_ocn + (hbr - h_ocn) * torch.exp(-K * dt)

    hin_safe = torch.clamp(hin, min=cst.puny)
    fbri_new = torch.clamp(hbr / hin_safe, FBRI_MIN, FBRI_MAX)
    fbri_new = torch.where(mask, fbri_new, 0.0)
    # newly formed ice starts at fbri = 1
    newice = (~(fbri > cst.puny)) & mask
    fbri_new = torch.where(newice, FBRI_INIT, fbri_new)

    hbri = torch.sum(torch.where(mask, aicen * fbri_new * hin, 0.0), dim=0)
    return HbrineOut(fbri=fbri_new, hbri=hbri,
                     darcy_V=torch.where(mask, darcy_V, 0.0))
