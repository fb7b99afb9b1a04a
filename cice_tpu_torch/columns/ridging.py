"""Rothrock ice strength (the `ice_strength` part of
cice_tpu/columns/ridging.py, with the participation and redistribution
shapes it needs; `ridge_ice` comes with ROADMAP: slice 2).

Lipscomb et al. (2007) exponential participation/redistribution
(krdg_partic=1 / krdg_redist=1), Rothrock (1975) energetics strength
(kstrength=1), Hibler (1979) strength (kstrength=0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as cst

ASTAR = 0.05          # e-folding of the exponential participation function
MAXRAFT = 1.0         # max thickness of rafting ice (m)
CP = 0.5 * cst.gravit * (cst.rhow - cst.rhoi) * cst.rhoi / cst.rhow


class RidgeParams(NamedTuple):
    apartic: torch.Tensor    # (ncat+1, ny, nx) participation: [open water, cats]
    hrmin: torch.Tensor      # (ncat, ny, nx) min ridge thickness
    hrexp: torch.Tensor      # (ncat, ny, nx) e-folding ridge thickness scale
    krdg: torch.Tensor       # (ncat, ny, nx) ridge thickness multiplier
    aksum: torch.Tensor      # net area removed per unit area participating


def ridge_participation(aicen, aice0, mu_rdg):
    """Exponential participation function b(h) ~ exp(-G/astar) (Lipscomb
    2007 eq. 4-5) per category; open water participates first."""
    ncat = aicen.shape[0]
    G = [aice0]
    for n in range(ncat):
        G.append(G[-1] + aicen[n])
    expG = [torch.exp(-g / ASTAR) for g in G]
    apartic = [expG[i] - expG[i + 1] for i in range(ncat)]
    ap0 = 1.0 - expG[0]
    tot = ap0 + sum(apartic)
    tot = torch.clamp(tot, min=cst.puny)
    apartic = [a / tot for a in apartic]
    ap0 = ap0 / tot
    return torch.stack([ap0] + apartic)


def ridge_shapes(aicen, vicen, mu_rdg):
    """hrmin, hrexp, krdg per donor category (Lipscomb 2007 eq. 8-11)."""
    hi = torch.where(aicen > cst.puny,
                     vicen / torch.clamp(aicen, min=cst.puny), 0.0)
    hi = torch.clamp(hi, min=cst.puny)
    hrmin = torch.minimum(2.0 * hi, hi + MAXRAFT)
    hrexp = mu_rdg * torch.sqrt(hi)
    hrmean = torch.maximum(hrmin + hrexp, 2.0 * hi)
    krdg = hrmean / hi
    return hrmin, hrexp, krdg


def ridge_prep(aicen, vicen, aice0, mu_rdg) -> RidgeParams:
    apartic = ridge_participation(aicen, aice0, mu_rdg)
    hrmin, hrexp, krdg = ridge_shapes(aicen, vicen, mu_rdg)
    aksum = apartic[0] + sum(apartic[1 + n] * (1.0 - 1.0 / krdg[n])
                             for n in range(krdg.shape[0]))
    return RidgeParams(apartic=apartic, hrmin=hrmin, hrexp=hrexp, krdg=krdg,
                       aksum=torch.clamp(aksum, min=cst.puny))


def ice_strength(aicen, vicen, aice, vice, cfg_dyn):
    """Ice strength P (N/m). kstrength=0: Hibler 79; 1: Rothrock 75
    energetics with the exponential redistribution moments."""
    if cfg_dyn.kstrength == 0:
        return cfg_dyn.Pstar * vice * torch.exp(-cfg_dyn.Cstar * (1.0 - aice))
    aice0 = torch.clamp(1.0 - aice, 0.0, 1.0)
    rp = ridge_prep(aicen, vicen, aice0, cfg_dyn.mu_rdg)
    ncat = aicen.shape[0]
    hi = torch.where(aicen > cst.puny,
                     vicen / torch.clamp(aicen, min=cst.puny), 0.0)
    P = torch.zeros_like(aice)
    for n in range(ncat):
        # PE change per unit closing from donor n (Lipscomb 2007 eq. 20)
        m2 = (rp.hrmin[n] ** 2 + 2.0 * rp.hrmin[n] * rp.hrexp[n]
              + 2.0 * rp.hrexp[n] ** 2)
        P = P + rp.apartic[1 + n] * (-hi[n] ** 2 + m2 / rp.krdg[n])
    P = cfg_dyn.Cf * CP * P / rp.aksum
    return torch.clamp(P, min=0.0)
