"""Shared dynamics machinery: preparation, momentum stepping, viscosities
(PyTorch port of cice_tpu/dynamics/common.py; reference ice_dyn_shared.F90
dyn_prep1:496, dyn_prep2:593, stepu:847, strain_rates:2083,
visc_replpress:2446, seabed_stress_factor_LKD:1386).

Every routine is a dense masked stencil over the global (ny, nx) tensors;
`torch.where` carries the active-cell logic of the reference's index lists.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import constants as cst
from ..constants import FIELD_LOC_NECORNER, FIELD_TYPE_VECTOR
from ..core.grid import Grid, grid_average_X2Y
from ..core.halo import shift


class EvpParams(NamedTuple):
    """EVP relaxation parameters (set_evp_parameters,
    ice_dyn_shared.F90:453-485); plain Python numbers."""
    arlx1i: float
    brlx: float
    denom1: float
    revp: float
    e_factor: float
    epp2i: float
    deltaminEVP: float
    capping: float
    Ktens: float
    ndte: int


def evp_params(cfg_dyn, dt: float) -> EvpParams:
    e_factor = cfg_dyn.e_yieldcurve ** 2 / cfg_dyn.e_plasticpot ** 4
    epp2i = 1.0 / cfg_dyn.e_plasticpot ** 2
    capping = 1.0 if cfg_dyn.capping_method == "max" else 0.0
    if cfg_dyn.revised_evp:
        revp = 1.0
        denom1 = 1.0
        arlx1i = 1.0 / cfg_dyn.arlx
        brlx = cfg_dyn.brlx
    else:
        revp = 0.0
        arlx = 2.0 * cfg_dyn.elasticDamp * float(cfg_dyn.ndte)
        arlx1i = 1.0 / arlx
        brlx = float(cfg_dyn.ndte)
        denom1 = 1.0 / (1.0 + arlx1i)
    return EvpParams(arlx1i=arlx1i, brlx=brlx, denom1=denom1, revp=revp,
                     e_factor=e_factor, epp2i=epp2i,
                     deltaminEVP=cfg_dyn.deltaminEVP, capping=capping,
                     Ktens=cfg_dyn.Ktens, ndte=cfg_dyn.ndte)


def ice_strength_hibler(aice, vice, Pstar=cst.Pstar, Cstar=cst.Cstar):
    """P = P* h exp(-C*(1-A)) — Hibler (1979), kstrength=0."""
    return Pstar * vice * torch.exp(-Cstar * (1.0 - aice))


#: every tensor field of DynPrep, in declaration order
DYNPREP_FIELDS = ("iceTmask", "iceUmask", "aiU", "umassdti", "fm", "waterx",
                  "watery", "forcex", "forcey", "uvel_init", "vvel_init",
                  "uvel", "vvel", "Cw", "TbU")


@dataclass(frozen=True)
class DynPrep:
    iceTmask: torch.Tensor     # bool (ny,nx): ice present near T-cell
    iceUmask: torch.Tensor     # bool: active momentum points
    aiU: torch.Tensor          # ice fraction at U
    umassdti: torch.Tensor     # U-cell mass / dt (kg/m^2/s)
    fm: torch.Tensor           # coriolis * mass (kg/s)
    waterx: torch.Tensor       # rotated ocean current for drag
    watery: torch.Tensor
    forcex: torch.Tensor       # wind stress + ssh tilt (N/m^2)
    forcey: torch.Tensor
    uvel_init: torch.Tensor
    vvel_init: torch.Tensor
    uvel: torch.Tensor         # velocity after new-ice init / masking
    vvel: torch.Tensor
    Cw: torch.Tensor           # ocean drag coefficient at U
    TbU: torch.Tensor          # seabed stress factor (N/m^2)


def dyn_prep(grid: Grid, cfg_dyn, dt: float, *,
             aice, vice, vsno, aiceU_prev_mask,
             uvel, vvel, strairxT, strairyT, uocn_T, vocn_T,
             ss_tltx_T, ss_tlty_T, Cw_in=None) -> DynPrep:
    """Per-dynamics-step momentum-equation inputs (dyn_prep1 + dyn_prep2).
    All inputs at T points except uvel/vvel (U)."""
    bc = grid.bc
    tmask = grid.tmask
    umask = grid.umask

    tmass = torch.where(tmask, cst.rhoi * vice + cst.rhos * vsno, 0.0)
    tmphm = tmask & (aice > 1e-11) & (tmass > 1e-10)
    tmphm_f = tmphm.to(torch.float32)
    near = tmphm
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if dj == 0 and di == 0:
                continue
            near = near | (shift(tmphm_f, dj, di, bc=bc) > 0.5)
    iceTmask = near & tmask

    aiU = grid_average_X2Y("S", aice, "T", "U", grid)
    umass = grid_average_X2Y("S", tmass, "T", "U", grid)
    uocn = grid_average_X2Y("S", uocn_T, "T", "U", grid)
    vocn = grid_average_X2Y("S", vocn_T, "T", "U", grid)
    strairx = grid_average_X2Y("F", strairxT, "T", "U", grid)
    strairy = grid_average_X2Y("F", strairyT, "T", "U", grid)
    ss_tltx = grid_average_X2Y("S", ss_tltx_T, "T", "U", grid)
    ss_tlty = grid_average_X2Y("S", ss_tlty_T, "T", "U", grid)

    iceUmask = umask & (aiU > 1e-11) & (umass > 1e-10)
    newice = iceUmask & ~aiceU_prev_mask
    uvel = torch.where(newice, uocn, uvel)
    vvel = torch.where(newice, vocn, vvel)
    uvel = torch.where(iceUmask, uvel, 0.0)
    vvel = torch.where(iceUmask, vvel, 0.0)

    umassdti = torch.where(iceUmask, umass / dt, 0.0)
    fcor = grid.fcor("U", cfg_dyn.coriolis)
    fm = torch.where(iceUmask, fcor * umass, 0.0)
    sgn = torch.sign(torch.where(fm == 0, 1.0, fm))
    waterx = torch.where(iceUmask, uocn * cst.cosw - vocn * cst.sinw * sgn,
                         0.0)
    watery = torch.where(iceUmask, vocn * cst.cosw + uocn * cst.sinw * sgn,
                         0.0)

    if cfg_dyn.ssh_stress == "geostrophic":
        strtltx = -fm * vocn
        strtlty = fm * uocn
    else:  # 'coupled'
        strtltx = -cst.gravit * umass * ss_tltx
        strtlty = -cst.gravit * umass * ss_tlty
    forcex = torch.where(iceUmask, strairx + strtltx, 0.0)
    forcey = torch.where(iceUmask, strairy + strtlty, 0.0)

    Cw = torch.full_like(aiU, cst.dragio) if Cw_in is None else Cw_in
    if cfg_dyn.seabed_stress:
        TbU = seabed_stress_LKD(grid, cfg_dyn, aice, vice, iceUmask)
    else:
        TbU = torch.zeros_like(aiU)

    return DynPrep(iceTmask=iceTmask, iceUmask=iceUmask, aiU=aiU,
                   umassdti=umassdti, fm=fm, waterx=waterx, watery=watery,
                   forcex=forcex, forcey=forcey,
                   uvel_init=uvel, vvel_init=vvel, uvel=uvel, vvel=vvel,
                   Cw=Cw, TbU=TbU)


def seabed_stress_LKD(grid: Grid, cfg_dyn, aice, vice, iceUmask):
    """Lemieux et al. landfast-ice seabed stress factor at U points."""
    bc = grid.bc
    offs = [(0, 0), (0, 1), (1, 0), (1, 1)]
    sh = lambda f, dj, di: shift(f, dj, di, bc=bc)
    hw4 = [sh(grid.bathymetry, dj, di) for dj, di in offs]
    # land neighbors (depth 0) count as infinitely deep for the min
    hwu = torch.stack([torch.where(h > 0, h, 1e30) for h in hw4]).amin(0)
    au = torch.stack([sh(aice, dj, di) for dj, di in offs]).amax(0)
    hu = torch.stack([sh(vice, dj, di) for dj, di in offs]).amax(0)
    docalc = (hwu < cfg_dyn.threshold_hw) & iceUmask
    hcu = au * hwu / cfg_dyn.k1
    TbU = cfg_dyn.k2 * torch.clamp(hu - hcu, min=0.0) * torch.exp(
        -cfg_dyn.alphab * (1.0 - au))
    return torch.where(docalc, TbU, 0.0)


def visc_replpress(strength, DminArea, Delta, p: EvpParams):
    """Viscosities and replacement pressure (visc_replpress:2446); the
    1e-30 floor only guards zero-area padding."""
    if p.capping == 1.0:
        tmp = strength / torch.clamp(torch.maximum(Delta, DminArea),
                                     min=1e-30)
    elif p.capping == 0.0:
        tmp = strength / torch.clamp(Delta + DminArea, min=1e-30)
    else:
        tmp = (p.capping * (strength / torch.clamp(
            torch.maximum(Delta, DminArea), min=1e-30)) +
            (1.0 - p.capping) * (strength / torch.clamp(Delta + DminArea,
                                                        min=1e-30)))
    zetax2 = (1.0 + p.Ktens) * tmp
    rep_prs = (1.0 - p.Ktens) * tmp * Delta
    etax2 = p.epp2i * zetax2
    return zetax2, etax2, rep_prs


RHEO_AREA_MIN = 1.0e-3   # reference rheo_area_min (ice_dyn_shared.F90:67)


def stepu_dense(uvel, vvel, strintx, strinty, prep: DynPrep, p: EvpParams,
                uocn, vocn):
    """Momentum update given the internal stress divergence (stepu:847):
    implicit Coriolis + water drag 2x2 solve, with the rheology cutoff
    aiU > rheo_area_min on the stress divergence."""
    uold, vold = uvel, vvel
    vrel = prep.aiU * cst.rhow * prep.Cw * torch.sqrt((uocn - uold) ** 2 +
                                                      (vocn - vold) ** 2)
    taux = vrel * prep.waterx
    tauy = vrel * prep.watery
    Cb = prep.TbU / (torch.sqrt(uold ** 2 + vold ** 2) + cst.u0)
    cca = (p.brlx + p.revp) * prep.umassdti + vrel * cst.cosw + Cb
    sgn = torch.sign(torch.where(prep.fm == 0, 1.0, prep.fm))
    ccb = prep.fm + sgn * vrel * cst.sinw
    ab2 = cca * cca + ccb * ccb
    rf = (prep.aiU > RHEO_AREA_MIN).to(uold.dtype)
    cc1 = rf * strintx + prep.forcex + taux + \
        prep.umassdti * (p.brlx * uold + p.revp * prep.uvel_init)
    cc2 = rf * strinty + prep.forcey + tauy + \
        prep.umassdti * (p.brlx * vold + p.revp * prep.vvel_init)
    ab2 = torch.where(prep.iceUmask, ab2, 1.0)
    rab2 = 1.0 / ab2
    unew = torch.where(prep.iceUmask, (cca * cc1 + ccb * cc2) * rab2, 0.0)
    vnew = torch.where(prep.iceUmask, (cca * cc2 - ccb * cc1) * rab2, 0.0)
    taubx = -unew * Cb
    tauby = -vnew * Cb
    return unew, vnew, taubx, tauby


def deformations_B(grid: Grid, uvel, vvel, p: EvpParams, dt_dyn: float):
    """divu, shear, Delta at T points from corner strain rates (B grid)."""
    sr = strain_rates_B(grid, uvel, vvel, p)
    tarear = grid.tarear
    divu = 0.25 * (sr.divune + sr.divunw + sr.divuse + sr.divusw) * tarear
    tension = 0.25 * (sr.tensionne + sr.tensionnw + sr.tensionse +
                      sr.tensionsw) * tarear
    shearing = 0.25 * (sr.shearne + sr.shearnw + sr.shearse +
                       sr.shearsw) * tarear
    shear = torch.sqrt(tension ** 2 + shearing ** 2)
    Delta = 0.25 * (sr.Deltane + sr.Deltanw + sr.Deltase + sr.Deltasw) * \
        tarear
    return divu, shear, Delta


class StrainRates(NamedTuple):
    divune: torch.Tensor
    divunw: torch.Tensor
    divuse: torch.Tensor
    divusw: torch.Tensor
    tensionne: torch.Tensor
    tensionnw: torch.Tensor
    tensionse: torch.Tensor
    tensionsw: torch.Tensor
    shearne: torch.Tensor
    shearnw: torch.Tensor
    shearse: torch.Tensor
    shearsw: torch.Tensor
    Deltane: torch.Tensor
    Deltanw: torch.Tensor
    Deltase: torch.Tensor
    Deltasw: torch.Tensor


def strain_rates_B(grid: Grid, uvel, vvel, p: EvpParams) -> StrainRates:
    """Bilinear corner strain rates * area (m^2/s) at each T cell
    (reference strain_rates:2083; NE/NW/SW/SE corners). uvel/vvel are
    U-point (NE-corner) fields; the W, S and SW corners are shifts."""
    shu = lambda f, dj, di: shift(f, dj, di, bc=grid.bc,
                                  loc=FIELD_LOC_NECORNER,
                                  ftype=FIELD_TYPE_VECTOR)
    u, v = uvel, vvel
    uw, vw = shu(u, 0, -1), shu(v, 0, -1)
    us, vs = shu(u, -1, 0), shu(v, -1, 0)
    usw, vsw = shu(u, -1, -1), shu(v, -1, -1)

    cyp, cxp, cym, cxm = grid.cyp, grid.cxp, grid.cym, grid.cxm
    dxT, dyT = grid.dxT, grid.dyT

    divune = cyp * u - dyT * uw + cxp * v - dxT * vs
    divunw = cym * uw + dyT * u + cxp * vw - dxT * vsw
    divusw = cym * usw + dyT * us + cxm * vsw + dxT * vw
    divuse = cyp * us - dyT * usw + cxm * vs + dxT * v

    tensionne = -cym * u - dyT * uw + cxm * v + dxT * vs
    tensionnw = -cyp * uw + dyT * u + cxm * vw + dxT * vsw
    tensionsw = -cyp * usw + dyT * us + cxp * vsw - dxT * vw
    tensionse = -cym * us - dyT * usw + cxp * vs - dxT * v

    shearne = -cym * v - dyT * vw - cxm * u - dxT * us
    shearnw = -cyp * vw + dyT * v - cxm * uw - dxT * usw
    shearsw = -cyp * vsw + dyT * vs - cxp * usw + dxT * uw
    shearse = -cym * vs - dyT * vsw - cxp * us + dxT * u

    ef = p.e_factor
    Deltane = torch.sqrt(divune ** 2 + ef * (tensionne ** 2 + shearne ** 2))
    Deltanw = torch.sqrt(divunw ** 2 + ef * (tensionnw ** 2 + shearnw ** 2))
    Deltasw = torch.sqrt(divusw ** 2 + ef * (tensionsw ** 2 + shearsw ** 2))
    Deltase = torch.sqrt(divuse ** 2 + ef * (tensionse ** 2 + shearse ** 2))

    return StrainRates(divune, divunw, divuse, divusw,
                       tensionne, tensionnw, tensionse, tensionsw,
                       shearne, shearnw, shearse, shearsw,
                       Deltane, Deltanw, Deltase, Deltasw)
