"""Salinity / melting-temperature profiles and enthalpies (the BL99 helpers
of cice_tpu/columns/thermo_vertical.py that the initial state needs; the
vertical thermodynamics comes with ROADMAP: slice 2)."""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as cst


def bl99_salinity(nilyr: int) -> np.ndarray:
    """Fixed BL99 salinity profile (psu) at layer midpoints:
    S(z) = (saltmax/2) [1 - cos(pi z^(nsal/(msal+z)))], z = (k-1/2)/nilyr."""
    z = (np.arange(nilyr) + 0.5) / nilyr
    return 0.5 * cst.saltmax * (1.0 - np.cos(
        np.pi * z ** (cst.nsal / (cst.msal + z))))


def melting_temps(salin):
    """Layer melting temperature Tm = -depressT * S (degC)."""
    return -cst.depressT * salin


def enthalpy_ice(T: torch.Tensor, Tm: float) -> torch.Tensor:
    """q_ice(T) (J/m^3), T<Tm<=0: sensible + brine latent + ocean part."""
    Ts = torch.clamp(T, max=Tm - 1e-6)
    return -cst.rhoi * (cst.cp_ice * (Tm - Ts)
                        + cst.Lfresh * (1.0 - Tm / Ts) - cst.cp_ocn * Tm)


def enthalpy_snow(T: torch.Tensor) -> torch.Tensor:
    return -cst.rhos * (cst.Lfresh - cst.cp_ice * T)
