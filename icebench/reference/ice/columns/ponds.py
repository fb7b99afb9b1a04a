"""Melt ponds (PyTorch port of cice_tpu/columns/ponds.py): level-ice ponds
(tr_pond_lvl; Hunke, Hebert & Lecomte 2013), sea-level ponds
(tr_pond_sealvl) and topographic ponds in their bucket-limit form
(tr_pond_topo; Flocco & Feltham 2007), and the radiatively exposed pond
fraction that delta-Eddington shortwave reads.

Pond tracer state per category, (ncat, ny, nx), dense and masked:
  apnd — pond area as a fraction of the pond-bearing ice area (the
         level-ice area for the lvl scheme, the category area otherwise)
  hpnd — mean pond depth over the pond area (m)
  ipnd — refrozen pond lid thickness (m)
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import constants as cst
from ..ops import lsum

TP_FRZ = -2.0          # pond refreezing onset temperature Tp (degC)
KICE_LID = 2.03        # conductivity of the refrozen lid (W/m/K, fresh ice)
DPSCALE_REF = 1.0e-3   # reference drainage scale (s^-1 at hp=1m head)

POND_DIAGS = ("dpnd_flush", "dpnd_initial", "dpnd_expon", "dpnd_freebd",
              "dpnd_dlid")


class PondOut(NamedTuple):
    apnd: torch.Tensor
    hpnd: torch.Tensor
    ipnd: torch.Tensor
    apeff: torch.Tensor       # pond fraction exposed to radiation
    dpnd_flush: torch.Tensor  # freshwater flushed to ocean this step (m)
    # pond water budget terms (m of water per category area per step);
    # None where a scheme has no such term
    dpnd_initial: Optional[torch.Tensor] = None  # meltwater collected
    dpnd_expon: Optional[torch.Tensor] = None
    dpnd_freebd: Optional[torch.Tensor] = None
    dpnd_dlid: Optional[torch.Tensor] = None     # water frozen into the lid


def _lid_growth(frzpnd: str, ipnd, Tsf, dt):
    """Refrozen-lid thickening for cold surfaces ('hlid': Stefan growth
    d(h^2)/dt = 2 k (Tp-Tsf) / (rhoi Lf)). Returns (ipnd_new, dlid) with
    dlid signed: growth consumes pond water, melt-back returns it."""
    cold = Tsf < TP_FRZ
    stefan = torch.sqrt(torch.clamp(
        ipnd * ipnd + 2.0 * KICE_LID * torch.clamp(TP_FRZ - Tsf, min=0.0)
        * dt / (cst.rhoi * cst.Lfresh), min=0.0))
    ipnd_new = torch.where(
        cold, stefan, torch.clamp(ipnd - 0.01 * dt / cst.secday, min=0.0))
    return ipnd_new, ipnd_new - ipnd


def compute_ponds_lvl(cfg_ponds, dt, *, aicen, vicen, vsnon, alvl, apnd, hpnd,
                      ipnd, Tsf, meltt, melts, frain, aice):
    """Level-ice pond evolution (tr_pond_lvl).

    meltt/melts: ice/snow melt this step (m, per category); frain rain rate
    (kg/m^2/s). Ponds collect a runoff fraction of surface meltwater onto
    the level-ice portion of each category, with depth tied to area
    (hpnd = pndaspect*apnd), drainage through warm permeable ice, and a
    refrozen lid (frzpnd='hlid' Stefan / 'cesm' exponential).
    """
    mask = (aicen > cst.puny) & (alvl * aicen > 0.01)
    alvl_frac = torch.clamp(alvl, 0.0, 1.0)

    volp = apnd * hpnd       # pond volume per unit level-ice area (m)

    # --- meltwater collection ------------------------------------------
    rfrac = cfg_ponds.rfracmin + (cfg_ponds.rfracmax - cfg_ponds.rfracmin) * \
        torch.clamp(aice, 0.0, 1.0)
    dvol = rfrac * (cst.rhoi * meltt + cst.rhos * melts +
                    frain * dt * apnd * alvl_frac) / cst.rhofresh
    dvol = torch.where(mask, dvol / torch.clamp(alvl_frac, min=cst.puny),
                       0.0)
    volp = volp + dvol

    # --- refreezing -----------------------------------------------------
    cold = Tsf < TP_FRZ
    if cfg_ponds.frzpnd == "cesm":
        shrink = torch.exp(0.01 * (Tsf - TP_FRZ) * dt / cst.secday)
        volp = torch.where(cold, volp * torch.clamp(shrink, 0.0, 1.0), volp)
        ipnd_new = torch.zeros_like(ipnd)
        dlid = torch.zeros_like(ipnd)
    else:
        ipnd_new, dlid_s = _lid_growth(cfg_ponds.frzpnd, ipnd, Tsf, dt)
        dlid = torch.clamp(dlid_s, min=0.0)
        volp = torch.clamp(volp - apnd * dlid_s * cst.rhoi / cst.rhofresh,
                           min=0.0)

    # --- drainage through warm permeable ice ------------------------------
    aicen_p = torch.clamp(aicen, min=cst.puny)
    hi = torch.where(aicen > cst.puny, vicen / aicen_p, 0.0)
    warm = Tsf > -0.5
    drain_frac = min(cfg_ponds.dpscale / DPSCALE_REF *
                     1.0e-3 * dt / cst.secday, 1.0)
    flush = torch.where(warm, volp * drain_frac, 0.0)
    volp = volp - flush

    # --- geometry: hpnd = pndaspect * apnd ------------------------------
    aspect = cfg_ponds.pndaspect
    apnd_new = torch.sqrt(torch.clamp(volp, min=0.0) / aspect)
    apnd_new = torch.clamp(apnd_new, 0.0, 1.0)
    hpnd_new = aspect * apnd_new
    # depth capped at 90% of category mean ice thickness
    hcap = 0.9 * hi
    over = hpnd_new > hcap
    hpnd_new = torch.minimum(hpnd_new, hcap)
    apnd_new = torch.where(
        over & (hpnd_new > cst.puny),
        torch.clamp(volp / torch.clamp(hpnd_new, min=cst.puny), 0.0, 1.0),
        apnd_new)

    apnd_new = torch.where(mask, apnd_new, 0.0)
    hpnd_new = torch.where(mask, hpnd_new, 0.0)
    ipnd_new = torch.where(mask, ipnd_new, 0.0)

    # --- radiative exposure (snow and the lid hide shallow ponds) --------
    hs = torch.where(aicen > cst.puny, vsnon / aicen_p, 0.0)
    snow_hide = torch.clamp(1.0 - hs / max(cfg_ponds.hs1, cst.puny),
                            0.0, 1.0)
    lid_hide = torch.clamp(
        1.0 - ipnd_new / max(10.0 * cfg_ponds.hp1, cst.puny), 0.0, 1.0)
    apeff = apnd_new * alvl_frac * snow_hide * lid_hide

    return PondOut(apnd=apnd_new, hpnd=hpnd_new, ipnd=ipnd_new, apeff=apeff,
                   dpnd_flush=torch.where(mask, flush, 0.0),
                   dpnd_initial=torch.where(mask, dvol, 0.0),
                   dpnd_dlid=torch.where(
                       mask, dlid * cst.rhoi / cst.rhofresh, 0.0))


def compute_ponds_sealvl(cfg_ponds, dt, *, aicen, vicen, vsnon, apnd, hpnd,
                         ipnd, Tsf, meltt, melts, frain, aice):
    """Sea-level ponds (tr_pond_sealvl): the pond surface relaxes to sea
    level. Meltwater collects at the equilibrium pond fraction `apnd_sl`
    of the category area; water above sea level drains exponentially on
    the timescale `tscale_pnd_drain` (days); water that would push the ice
    surface below sea level drains at once; a refrozen lid grows per
    `frzpnd`."""
    mask = aicen > cst.puny
    aicen_p = torch.clamp(aicen, min=cst.puny)
    hi = torch.where(mask, vicen / aicen_p, 0.0)
    hs = torch.where(mask, vsnon / aicen_p, 0.0)

    volp = apnd * hpnd                  # m of water per category area

    # --- meltwater collection (rfrac of surface melt + rain on ponds) ---
    rfrac = cfg_ponds.rfracmin + (cfg_ponds.rfracmax - cfg_ponds.rfracmin) * \
        torch.clamp(aice, 0.0, 1.0)
    dvol_in = rfrac * (cst.rhoi * meltt + cst.rhos * melts +
                       frain * dt * apnd) / cst.rhofresh
    dvol_in = torch.where(mask, dvol_in, 0.0)
    volp = volp + dvol_in

    # --- refrozen lid (displaces pond water) -----------------------------
    if cfg_ponds.frzpnd == "cesm":
        cold = Tsf < TP_FRZ
        shrink = torch.exp(0.01 * (Tsf - TP_FRZ) * dt / cst.secday)
        volp = torch.where(cold, volp * torch.clamp(shrink, 0.0, 1.0), volp)
        ipnd_new = torch.zeros_like(ipnd)
        dlid = torch.zeros_like(ipnd)
    else:
        ipnd_new, dlid_s = _lid_growth(cfg_ponds.frzpnd, ipnd, Tsf, dt)
        dlid = torch.clamp(dlid_s, min=0.0)
        volp = torch.clamp(volp - apnd * dlid_s * cst.rhoi / cst.rhofresh,
                           min=0.0)

    # --- equilibrium geometry: pond fraction relaxes to apnd_sl ----------
    has_water = volp > cst.puny
    apnd_new = torch.where(has_water, cfg_ponds.apnd_sl,
                           torch.zeros_like(volp))
    hpnd_new = torch.where(has_water,
                           volp / torch.clamp(apnd_new, min=cst.puny), 0.0)

    # --- sea-level drainage ----------------------------------------------
    # ice freeboard below the pond-free surface (snow load included)
    freebd = torch.clamp(hi * (cst.rhow - cst.rhoi) / cst.rhow -
                         hs * cst.rhos / cst.rhow, min=0.0)
    # (a) water above sea level drains on the timescale tscale (days)
    tau = max(cfg_ponds.tscale_pnd_drain, 1e-3) * cst.secday
    above = torch.clamp(hpnd_new - freebd, min=0.0) * apnd_new
    dpnd_expon = above * (1.0 - math.exp(-dt / tau))
    volp = torch.clamp(volp - dpnd_expon, min=0.0)
    # (b) pond mass may not push the surface below sea level
    vol_max = torch.clamp(
        (cst.rhow * hi - cst.rhoi * hi - cst.rhos * hs) / cst.rhofresh,
        min=0.0)
    dpnd_freebd = torch.clamp(volp - vol_max, min=0.0)
    volp = volp - dpnd_freebd

    hpnd_new = torch.where(apnd_new > cst.puny,
                           volp / torch.clamp(apnd_new, min=cst.puny), 0.0)
    flush = dpnd_expon + dpnd_freebd

    apnd_new = torch.where(mask, apnd_new, 0.0)
    hpnd_new = torch.where(mask, hpnd_new, 0.0)
    ipnd_new = torch.where(mask, ipnd_new, 0.0)

    snow_hide = torch.clamp(1.0 - hs / max(cfg_ponds.hs1, cst.puny),
                            0.0, 1.0)
    lid_hide = torch.clamp(
        1.0 - ipnd_new / max(10.0 * cfg_ponds.hp1, cst.puny), 0.0, 1.0)
    apeff = apnd_new * snow_hide * lid_hide

    return PondOut(apnd=apnd_new, hpnd=hpnd_new, ipnd=ipnd_new, apeff=apeff,
                   dpnd_flush=torch.where(mask, flush, 0.0),
                   dpnd_initial=torch.where(mask, dvol_in, 0.0),
                   dpnd_expon=torch.where(mask, dpnd_expon, 0.0),
                   dpnd_freebd=torch.where(mask, dpnd_freebd, 0.0),
                   dpnd_dlid=torch.where(
                       mask, dlid * cst.rhoi / cst.rhofresh, 0.0))


def compute_ponds_topo(cfg_ponds, dt, *, aicen, vicen, vsnon, apnd, hpnd,
                       ipnd, Tsf, meltt, melts, frain, aice):
    """Topographic ponds in bucket-limit form (tr_pond_topo): ponds cover
    the category area with a fixed aspect, water above the freeboard bucket
    drains at once, and a Stefan lid exchanges water with the pond."""
    mask = aicen > cst.puny
    volp = apnd * hpnd

    rfrac = cfg_ponds.rfracmin + (cfg_ponds.rfracmax - cfg_ponds.rfracmin) * \
        torch.clamp(aice, 0.0, 1.0)
    dvol = rfrac * (cst.rhoi * meltt + cst.rhos * melts +
                    frain * dt * apnd) / cst.rhofresh
    volp = volp + torch.where(mask, dvol, 0.0)

    cold = Tsf < TP_FRZ
    shrink = torch.exp(0.01 * (Tsf - TP_FRZ) * dt / cst.secday)
    volp = torch.where(cold, volp * torch.clamp(shrink, 0.0, 1.0), volp)

    # hydrostatic drainage: the pond surface cannot rise above sea level
    aicen_p = torch.clamp(aicen, min=cst.puny)
    hi = torch.where(mask, vicen / aicen_p, 0.0)
    hs = torch.where(mask, vsnon / aicen_p, 0.0)
    freeboard = torch.clamp(
        hi - (cst.rhoi * hi + cst.rhos * hs) / cst.rhow, min=0.0)
    vol_max = 0.9 * freeboard + 0.0 * hi     # bucket capacity ~ freeboard
    flush = torch.clamp(volp - vol_max, min=0.0)
    volp = volp - flush

    ipnd_new, dlid_s = _lid_growth("hlid", ipnd, Tsf, dt)
    volp = torch.clamp(volp - apnd * dlid_s * cst.rhoi / cst.rhofresh,
                       min=0.0)

    apnd_new = torch.clamp(torch.sqrt(torch.clamp(volp, min=0.0) /
                                      cfg_ponds.pndaspect), 0.0, 1.0)
    hpnd_new = cfg_ponds.pndaspect * apnd_new

    apnd_new = torch.where(mask, apnd_new, 0.0)
    hpnd_new = torch.where(mask, hpnd_new, 0.0)
    ipnd_new = torch.where(mask, ipnd_new, 0.0)
    hs_hide = torch.clamp(1.0 - hs / max(cfg_ponds.hs1, cst.puny), 0.0, 1.0)
    return PondOut(apnd=apnd_new, hpnd=hpnd_new, ipnd=ipnd_new,
                   apeff=apnd_new * hs_hide,
                   dpnd_flush=torch.where(mask, flush, 0.0),
                   dpnd_initial=torch.where(mask, dvol, 0.0),
                   dpnd_freebd=torch.where(mask, flush, 0.0),
                   dpnd_dlid=torch.where(
                       mask, torch.clamp(dlid_s, min=0.0) *
                       cst.rhoi / cst.rhofresh, 0.0))


def step_ponds(cfg, dt, *, aicen, vicen, vsnon, trcrn, Tsf, meltt, melts,
               frain, aice, return_diag: bool = False):
    """Update the pond tracers of a copy of trcrn; returns (trcrn, apeff,
    flush) with apeff the per-category radiatively-exposed pond fraction.
    With return_diag=True a 4th element carries the per-category pond water
    budget terms (zeros where the scheme has no such term)."""
    t = cfg.tracers
    zero = torch.zeros_like(aicen)
    if not (t.tr_pond_lvl or t.tr_pond_topo or t.tr_pond_sealvl):
        if return_diag:
            return trcrn, zero, zero, {k: zero for k in POND_DIAGS}
        return trcrn, zero, zero
    trcrn = dict(trcrn)
    common = dict(aicen=aicen, vicen=vicen, vsnon=vsnon,
                  apnd=trcrn["apnd"], hpnd=trcrn["hpnd"], ipnd=trcrn["ipnd"],
                  Tsf=Tsf, meltt=meltt, melts=melts, frain=frain, aice=aice)
    if t.tr_pond_lvl and "alvl" in trcrn:
        out = compute_ponds_lvl(cfg.ponds, dt, alvl=trcrn["alvl"], **common)
    elif t.tr_pond_sealvl:
        out = compute_ponds_sealvl(cfg.ponds, dt, **common)
    else:
        out = compute_ponds_topo(cfg.ponds, dt, **common)
    trcrn["apnd"] = out.apnd
    trcrn["hpnd"] = out.hpnd
    trcrn["ipnd"] = out.ipnd
    if return_diag:
        diag = {k: (getattr(out, k) if getattr(out, k) is not None else zero)
                for k in POND_DIAGS}
        return trcrn, out.apeff, out.dpnd_flush, diag
    return trcrn, out.apeff, out.dpnd_flush


def pond_reservoir_mass(trcrn, aicen, lvl: bool):
    """Pond water mass per unit cell area (kg/m^2): liquid plus refrozen lid
    (water-equivalent), on the level-ice area for tr_pond_lvl. The one
    pond-reservoir definition shared by the coupler fresh-flux assembly
    (model/step.py) and the freshwater budget (model/diagnostics.py)."""
    if "apnd" not in trcrn or "hpnd" not in trcrn:
        return torch.zeros(aicen.shape[1:], dtype=aicen.dtype,
                           device=aicen.device)
    norm = torch.clamp(trcrn["alvl"], 0.0, 1.0) \
        if (lvl and "alvl" in trcrn) else torch.ones_like(aicen)
    apnd = trcrn["apnd"]
    liquid = cst.rhofresh * apnd * trcrn["hpnd"]
    lid = cst.rhoi * apnd * trcrn["ipnd"] if "ipnd" in trcrn \
        else torch.zeros_like(apnd)
    return lsum(aicen * norm * (liquid + lid), dim=0)


def pond_exposure(cfg, *, aicen, vsnon, trcrn):
    """Radiatively exposed pond fraction (per category area) of the
    current tracer state: delta-Eddington shortwave reads it at the top of
    the step, before the pond update."""
    if "apnd" not in trcrn:
        return torch.zeros_like(aicen)
    apnd, ipnd = trcrn["apnd"], trcrn["ipnd"]
    hs = torch.where(aicen > cst.puny,
                     vsnon / torch.clamp(aicen, min=cst.puny), 0.0)
    snow_hide = torch.clamp(1.0 - hs / max(cfg.ponds.hs1, cst.puny),
                            0.0, 1.0)
    lid_hide = torch.clamp(
        1.0 - ipnd / max(10.0 * cfg.ponds.hp1, cst.puny), 0.0, 1.0)
    out = apnd
    if cfg.tracers.tr_pond_lvl and "alvl" in trcrn:
        out = out * torch.clamp(trcrn["alvl"], 0.0, 1.0)
    return torch.clamp(out * snow_hide * lid_hide, 0.0, 1.0)
