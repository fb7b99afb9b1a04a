"""Slab ocean mixed layer and the ocean freezing temperature (PyTorch port
of cice_tpu/columns/ocean.py)."""

from __future__ import annotations

import torch

from .. import constants as cst
from .atmo import atmo_boundary_layer, saturated_specific_humidity_ocn

FRZMLT_MAX = 1000.0   # bound on freezing/melting potential (W/m^2)


# the piecewise-linear mushy liquidus S_br(T) (g/kg, degC; Turner, Hunke &
# Jeffery 2013): warm branch S = -a1 T, cold branch S = -a2 T + b2
AZ1_LIQ = 18.48
AZ2_LIQ = 10.3085
BZ2_LIQ = 62.4
S_JOIN = AZ1_LIQ * (BZ2_LIQ / (AZ1_LIQ - AZ2_LIQ))   # 141.1 g/kg


def liquidus_temperature(S: torch.Tensor) -> torch.Tensor:
    """Liquidus temperature T_liq(S) (degC); S in g/kg (>=0)."""
    Ss = torch.clamp(S, min=0.0)
    warm = Ss <= S_JOIN
    return torch.where(warm, -Ss / AZ1_LIQ, -(Ss - BZ2_LIQ) / AZ2_LIQ)


def freezing_temperature(sss: torch.Tensor,
                         option: str = "mushy") -> torch.Tensor:
    """Tf(SSS) (degC). 'minus1p8'/'constant': -1.8; 'linear_salt':
    -depressT*S; 'mushy': the piecewise-linear mushy liquidus."""
    if option in ("minus1p8", "constant"):
        return torch.full_like(sss, -1.8)
    if option == "linear_salt":
        return -cst.depressT * sss
    return liquidus_temperature(sss)


def ocean_mixed_layer(dt, *, sst, Tf, hmix, qdp, frzmlt_old,
                      aice, fhocn_ice, fswthru_ice, fresh_unused,
                      flw, swvdr, swvdf, swidr, swidf,
                      potT, Qa, rhoa, wind, uatm, vatm, zlvl):
    """Advance the slab-ocean SST and compute frzmlt (W/m^2).

    fhocn_ice: net heat from ice to ocean (cell mean); fswthru_ice: SW
    through ice into the ocean. Open-water fluxes use the similarity scheme
    over water.
    """
    co = atmo_boundary_layer(sst, potT, uatm, vatm, wind, zlvl, Qa, rhoa,
                             over="ocn")
    TsfK = sst + cst.Tffresh
    qsfc = saturated_specific_humidity_ocn(TsfK, rhoa)
    fsens_ocn = co.shcoef * (potT - TsfK)
    flat_ocn = co.lhcoef * (Qa - qsfc)
    flwout_ocn = -cst.stefan_boltzmann * TsfK ** 4
    swabs_ocn = ((swvdr + swidr) * (1.0 - cst.albocn) +
                 (swvdf + swidf) * (1.0 - cst.albocn))
    fq_ow = fsens_ocn + flat_ocn + flwout_ocn + flw + swabs_ocn

    aice0 = torch.clamp(1.0 - aice, 0.0, 1.0)
    fnet = aice0 * fq_ow + fhocn_ice + fswthru_ice + qdp

    cph = cst.cprho * torch.clamp(hmix, min=1.0)
    sst_new = sst + fnet * dt / cph

    # freezing/melting potential: energy to bring the slab to Tf in one step
    frzmlt = (Tf - sst_new) * cph / dt
    frzmlt = torch.clamp(frzmlt, -FRZMLT_MAX, FRZMLT_MAX)
    # when freezing, reset SST to Tf (the latent heat comes from new ice)
    sst_new = torch.maximum(sst_new, Tf)
    return sst_new, frzmlt
