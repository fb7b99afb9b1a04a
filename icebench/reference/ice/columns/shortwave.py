"""Shortwave radiation: CCSM3 albedos and absorbed-flux partition (PyTorch
port of cice_tpu/columns/shortwave.py).

The CCSM3 sea-ice albedo parameterization (Briegleb et al. 2004) with
Beer's-law penetration: visible radiation penetrates bare ice with fraction
i0vis and decays as exp(-kappav z). Delta-Eddington is columns/dedd.py.
All functions are dense over (ncat, ny, nx) tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import constants as cst

# CCSM3 albedo temperature-dependence coefficients (Briegleb et al. 2004)
DALB_MLT = -0.075     # bare-ice albedo decrease near melt (both bands)
DALB_MLTV = -0.100    # snow albedo decrease near melt, visible
DALB_MLTI = -0.150    # snow albedo decrease near melt, near-IR


class ShortwaveOut(NamedTuple):
    alvdr: torch.Tensor    # visible direct albedo
    alvdf: torch.Tensor    # visible diffuse albedo
    alidr: torch.Tensor    # near-IR direct albedo
    alidf: torch.Tensor    # near-IR diffuse albedo
    fswsfc: torch.Tensor   # SW absorbed at surface (W/m^2)
    fswint: torch.Tensor   # SW absorbed internally (W/m^2)
    fswthru: torch.Tensor  # SW transmitted to ocean (W/m^2)
    Iswabs: torch.Tensor   # (..., nilyr, ny, nx) per-layer absorption
    fswpen: torch.Tensor   # SW penetrating below surface (W/m^2)


def albedos_ccsm3(Tsf, hi, hs, cfg_sw):
    """CCSM3 albedos (dense). Returns (alvdr, alvdf, alidr, alidf, asnow);
    direct == diffuse in this scheme."""
    fh = torch.clamp(torch.atan(4.0 * hi) / math.atan(4.0 * cfg_sw.ahmax),
                     max=1.0)
    albo = cst.albocn * (1.0 - fh)
    albiv = cfg_sw.albicev * fh + albo
    albii = cfg_sw.albicei * fh + albo
    # ramp as Tsf approaches melt over dT_mlt degrees
    dTs = cst.Timelt - Tsf
    fT = torch.clamp(dTs / cfg_sw.dT_mlt - 1.0, max=0.0)    # in [-1, 0]
    albiv = torch.clamp(albiv - DALB_MLT * fT, 0.0, 1.0)
    albii = torch.clamp(albii - DALB_MLT * fT, 0.0, 1.0)
    albsv = torch.clamp(cfg_sw.albsnowv - DALB_MLTV * fT, 0.0, 1.0)
    albsi = torch.clamp(cfg_sw.albsnowi - DALB_MLTI * fT, 0.0, 1.0)
    asnow = hs / (hs + cst.snowpatch)
    alvd = albiv * (1.0 - asnow) + albsv * asnow
    alid = albii * (1.0 - asnow) + albsi * asnow
    return alvd, alvd, alid, alid, asnow


def shortwave_ccsm3(Tsf, hi, hs, swvdr, swvdf, swidr, swidf, cfg_sw,
                    nilyr: int) -> ShortwaveOut:
    """Absorbed shortwave partition for a stacked-category field.

    Tsf/hi/hs: (..., ny, nx); sw* incident band fluxes (ny, nx), broadcast.
    """
    alvdr, alvdf, alidr, alidf, asnow = albedos_ccsm3(Tsf, hi, hs, cfg_sw)

    swabv = swvdr * (1.0 - alvdr) + swvdf * (1.0 - alvdf)
    swabi = swidr * (1.0 - alidr) + swidf * (1.0 - alidf)
    swabs = swabv + swabi

    # penetrating visible radiation through the bare-ice fraction
    fswpen = swabv * (1.0 - asnow) * cst.i0vis
    fswpen = torch.where(hi > cst.puny, fswpen, 0.0)

    # Beer's law between layer interfaces: exp(-kappa*z_k) is a geometric
    # sequence in the layer index, so one exp serves all layers
    r = torch.exp(-cst.kappav * torch.clamp(hi, min=0.0) / nilyr)
    e = torch.ones_like(hi)
    layers = []
    for _ in range(nilyr):
        e_next = e * r
        layers.append(fswpen * (e - e_next))
        e = e_next
    Iswabs = torch.stack(layers, dim=-3)
    fswthru = fswpen * e                 # e == exp(-kappav * hi)
    fswint = fswpen - fswthru
    fswsfc = swabs - fswpen

    return ShortwaveOut(alvdr=alvdr, alvdf=alvdf, alidr=alidr, alidf=alidf,
                        fswsfc=fswsfc, fswint=fswint, fswthru=fswthru,
                        Iswabs=Iswabs, fswpen=fswpen)
