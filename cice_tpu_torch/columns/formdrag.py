"""Form drag from sails, keels, floe edges and melt ponds (Tsamados et al.
2014, JPO 44; PyTorch port of cice_tpu/columns/formdrag.py).

The neutral 10-m atmospheric drag `Cdn_atm` and the ice-ocean drag
`Cdn_ocn` are skin friction plus form contributions:

  Cdn_atm = Cd_skin + Cd_rdg (sails) + Cd_floe (floe edges) + Cd_pond
  Cdn_ocn = Cw_skin + Cw_keel (keels) + Cw_floe (submerged floe edges)

Ridge geometry comes from the level-ice tracers (ardg = (1-alvl) aice,
vrdg = (1-vlvl) vice); each obstacle contributes
1/2 c S^2 (H/D) (ln(H/z0)/ln(zref/z0))^2 aice with the sheltering
S = 1 - exp(-sl D/H). The totals are capped at CAMAX / CWMAX. Elementwise
over the aggregate (ny, nx) state.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import constants as cst

# Tsamados et al. (2014) table of constants
CSA = 0.0005          # skin drag, atmosphere
CSW = 0.002           # skin drag, ocean
CRA = 0.2             # local form drag, sails
CRW = 0.2             # local form drag, keels
CFA = 0.2             # local form drag, floe edges (atm)
CFW = 0.3             # local form drag, floe edges (ocn)
CPA = 0.2             # local form drag, pond edges
SL = 0.18             # sheltering attenuation (Hanssen-Bauer & Gjessing)
ALPHA_R = math.radians(45.0)   # sail slope
ALPHA_K = math.radians(45.0)   # keel slope
PHI_R = 0.8           # sail porosity
PHI_K = 0.8           # keel porosity
HKOVERHR = 4.0        # keel-to-sail height ratio
DKOVERDR = 1.0        # keel-to-sail spacing ratio
LFLOE_CONST = 300.0   # floe length without FSD (m)
LPOND = 50.0          # pond length scale (m)
Z0_ICE = 0.0005       # ice surface roughness, atm side (m)
Z0_WAT = 0.0032       # roughness, ocean side (m)
ZREF = 10.0           # atm reference height (m)
ZREF_W = 5.0          # ocn reference depth (m)
CAMAX = 0.02          # cap on Cdn_atm (reference camax)
CWMAX = 0.06          # cap on Cdn_ocn
HS_MIN, HS_MAX = 0.2, 10.0     # sail height clamp (m)


class DragCoeffs(NamedTuple):
    Cdn_atm: torch.Tensor
    Cdn_ocn: torch.Tensor
    Cdn_atm_skin: torch.Tensor
    Cdn_atm_rdg: torch.Tensor
    Cdn_atm_floe: torch.Tensor
    Cdn_atm_pond: torch.Tensor
    Cdn_ocn_skin: torch.Tensor
    Cdn_ocn_keel: torch.Tensor
    Cdn_ocn_floe: torch.Tensor
    hfreebd: torch.Tensor
    hdraft: torch.Tensor
    hridge: torch.Tensor
    distrdg: torch.Tensor
    hkeel: torch.Tensor
    dkeel: torch.Tensor
    lfloe: torch.Tensor
    dfloe: torch.Tensor


def _logfac(H, z0):
    """(ln(H/z0)/ln(zref/z0))^2 attenuation of the local drag, for H above
    1.01 z0."""
    num = torch.log(torch.clamp(H, min=z0 * 1.01) / z0)
    den = math.log(ZREF / z0)
    return (num / den) ** 2


def neutral_drag_coeffs(*, aice, vice, vsno, alvl=None, vlvl=None,
                        apnd=None, hpnd=None, lfloe=None,
                        puny: float = 1e-11) -> DragCoeffs:
    """Aggregate-state form drag decomposition. alvl/vlvl are the
    aggregate level-ice area/volume fractions (per unit ice); apnd the
    pond fraction (per unit ice area); lfloe an optional (ny, nx) mean
    floe length from the FSD."""
    icemask = aice > puny
    ai = torch.clamp(aice, min=puny)
    hi = vice / ai
    hs = vsno / ai

    # hydrostatic freeboard and draft
    hdraft = (cst.rhoi * hi + cst.rhos * hs) / cst.rhow
    hfreebd = torch.clamp(hi + hs - hdraft, min=0.0)

    # ridge geometry from the level-ice tracers
    alvl = torch.ones_like(aice) if alvl is None else alvl
    vlvl = torch.ones_like(aice) if vlvl is None else vlvl
    ardg_frac = torch.clamp(1.0 - alvl, 0.0, 1.0)         # per unit ice area
    vrdg = torch.clamp(1.0 - vlvl, 0.0, 1.0) * vice       # per grid area
    ardg = ardg_frac * aice
    ardg_p = torch.clamp(ardg, min=puny)
    hrdg_mean = vrdg / ardg_p                             # ridged thickness
    Hs = torch.clamp(2.0 * hrdg_mean / (1.0 - PHI_R), HS_MIN, HS_MAX)
    have_rdg = ardg > puny
    Ds = torch.where(have_rdg,
                     2.0 * Hs * ai / (math.tan(ALPHA_R) * ardg_p), 1e8)
    Hk = HKOVERHR * Hs
    Dk = DKOVERDR * Ds

    # floe geometry: spacing from the open-water fraction (Tsamados eq. 26)
    if lfloe is None:
        lfloe = torch.full_like(aice, LFLOE_CONST)
    dfloe = lfloe / torch.sqrt(ai)

    # sheltering functions
    Sc_r = 1.0 - torch.exp(-SL * Ds / torch.clamp(Hs, min=puny))
    Sc_k = 1.0 - torch.exp(-SL * Dk / torch.clamp(Hk, min=puny))
    Sc_f = 1.0 - torch.exp(-SL * dfloe / torch.clamp(hfreebd, min=puny))

    # --- atmosphere ------------------------------------------------------
    rdg_ice = have_rdg & icemask
    cd_skin_a = CSA * aice
    cd_rdg = torch.where(rdg_ice,
                         0.5 * CRA * Sc_r ** 2 * (Hs / Ds) * aice
                         * _logfac(Hs, Z0_ICE), 0.0)
    cd_floe = torch.where(icemask,
                          0.5 * CFA * Sc_f ** 2 * (hfreebd / dfloe) * aice
                          * _logfac(hfreebd, Z0_ICE), 0.0)
    if apnd is None:
        cd_pond = torch.zeros_like(aice)
    else:
        hp = torch.zeros_like(aice) if hpnd is None else hpnd
        cd_pond = torch.where(
            icemask,
            0.5 * CPA * torch.sqrt(torch.clamp(apnd, 0.0, 1.0))
            * (torch.clamp(hp, 0.0, 1.0) / LPOND) * aice
            * _logfac(torch.clamp(hp, min=Z0_ICE * 2), Z0_ICE), 0.0)
    Cdn_atm = torch.clamp(cd_skin_a + cd_rdg + cd_floe + cd_pond, 0.0, CAMAX)

    # --- ocean -----------------------------------------------------------
    cw_skin = CSW * aice
    cw_keel = torch.where(rdg_ice,
                          0.5 * CRW * Sc_k ** 2 * (Hk / Dk) * aice
                          * _logfac(Hk, Z0_WAT), 0.0)
    cw_floe = torch.where(icemask,
                          0.5 * CFW * Sc_f ** 2 * (hdraft / dfloe) * aice
                          * _logfac(hdraft, Z0_WAT), 0.0)
    Cdn_ocn = torch.clamp(cw_skin + cw_keel + cw_floe, 0.0, CWMAX)
    # the classic constant where there is no ice at all
    Cdn_ocn = torch.where(icemask, torch.clamp(Cdn_ocn, min=1e-4),
                          cst.dragio)
    Cdn_atm = torch.where(icemask, torch.clamp(Cdn_atm, min=1e-4), CSA)

    return DragCoeffs(
        Cdn_atm=Cdn_atm, Cdn_ocn=Cdn_ocn,
        Cdn_atm_skin=cd_skin_a, Cdn_atm_rdg=cd_rdg, Cdn_atm_floe=cd_floe,
        Cdn_atm_pond=cd_pond, Cdn_ocn_skin=cw_skin, Cdn_ocn_keel=cw_keel,
        Cdn_ocn_floe=cw_floe, hfreebd=hfreebd, hdraft=hdraft,
        hridge=torch.where(have_rdg, Hs, 0.0),
        distrdg=torch.where(have_rdg, Ds, 0.0),
        hkeel=torch.where(have_rdg, Hk, 0.0),
        dkeel=torch.where(have_rdg, Dk, 0.0),
        lfloe=lfloe, dfloe=dfloe)


def drag_from_state(state, cfg) -> DragCoeffs:
    """The decomposition from a model State (aggregate tracers weighted by
    category area; the FSD's mean floe length where tr_fsd is on)."""
    ai = torch.clamp(state.aice, min=1e-11)
    trc = state.trcrn

    def agg(name):
        if name not in trc:
            return None
        return torch.sum(trc[name] * state.aicen, dim=0) / ai

    lf = None
    if "fsd" in trc and cfg.tracers.tr_fsd:
        from .fsd import fsd_bounds
        _, _, mid = fsd_bounds(cfg.domain.nfsd)
        r = torch.as_tensor(mid, dtype=ai.dtype, device=ai.device)
        f = torch.sum(trc["fsd"] * state.aicen[:, None], dim=0) / ai
        lf = 2.0 * torch.sum(f * r[:, None, None], dim=0) \
            / torch.clamp(torch.sum(f, dim=0), min=1e-11)
        lf = torch.clamp(lf, 8.0, 3.0e4)
    return neutral_drag_coeffs(
        aice=state.aice, vice=state.vice, vsno=state.vsno,
        alvl=agg("alvl"), vlvl=agg("vlvl"), apnd=agg("apnd"),
        hpnd=agg("hpnd"), lfloe=lf)
