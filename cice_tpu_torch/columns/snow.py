"""Advanced snow physics (tr_snow): grain metamorphism, liquid water, wind
compaction and redistribution (PyTorch port of cice_tpu/columns/snow.py;
Lecomte et al. 2013 wind compaction, Brun 1989 / Flanner & Zender 2006 dry
and wet grain metamorphism, the CICE snwredist level/ridged-ice transfer).

Snow tracers per category and snow layer (ncat, nslyr, ny, nx):
  smice — ice mass content of snow (kg/m^2 per layer)
  smliq — liquid water content of snow (kg/m^2 per layer)
  rhos_cmp — compaction-driven density contribution (kg/m^3)
  rsnw — grain radius (10^-6 m)
"""

from __future__ import annotations

import math

import torch

from .. import constants as cst
from ..ops import clip, lsum

# dry metamorphism e-folding time toward the temperature-dependent
# equilibrium radius (s); wet metamorphism rate (Brun 1989)
TAU_DRY = 5.0 * cst.secday
C_WET = 4.22e-5        # wet growth: dr^3/dt = C * (liq frac)^3


def snow_effective_density(cfg_snow, smice, smliq, rhos_cmp):
    """Bulk snow density from the compaction contribution (kg/m^3)."""
    del smice, smliq
    rhos = cst.rhos + rhos_cmp
    return torch.clamp(rhos, cfg_snow.rhosmin, cfg_snow.rhosmax)


def update_rhos_wind(cfg_snow, dt, rhos_cmp, wind):
    """Wind compaction (Lecomte et al. 2013): drho/dt above windmin."""
    drho = cfg_snow.drhosdwind * torch.clamp(wind - cfg_snow.windmin,
                                             min=0.0) * dt / cst.secday
    return torch.clamp(rhos_cmp + drho, 0.0,
                       cfg_snow.rhosmax - cfg_snow.rhosmin)


def grain_metamorphism(cfg_snow, dt, rsnw, Tsno, smice, smliq, Tgrd=None,
                       rhos_eff=None):
    """Grain radius evolution: dry growth toward a warm-limit radius (or at
    the SNICAR-table rates when snw_aging_table is 'test', 'snicar' or
    'file'); wet growth from the liquid content."""
    liq_frac = smliq / torch.clamp(smice + smliq, min=cst.puny)
    table_kind = cfg_snow.snw_aging_table
    if table_kind in ("test", "snicar", "file") and Tgrd is not None:
        from .snowtable import device_table, table_aging_rate
        axes, arrays = device_table(table_kind, cfg_snow.snw_filename,
                                    rsnw.dtype, rsnw.device)
        rhos_l = rhos_eff if rhos_eff is not None else \
            torch.full_like(rsnw, cst.rhos)
        rate = table_aging_rate(axes, arrays, Tsno * torch.ones_like(rsnw),
                                Tgrd, rhos_l, rsnw, cfg_snow.rsnw_fall)
        rs_dry = rsnw + rate * dt
    else:
        # dry: the equilibrium radius grows as the snow warms toward 0C
        warm = torch.clamp(1.0 + Tsno / 20.0, 0.0, 1.0)
        r_eq = cfg_snow.rsnw_fall + \
            (cfg_snow.rsnw_tmax - cfg_snow.rsnw_fall) * warm
        rs_dry = rsnw + (r_eq - rsnw) * (1.0 - math.exp(-dt / TAU_DRY))
    # wet: r^3 growth with the liquid fraction cubed (Brun 1989)
    r3 = rs_dry ** 3 + C_WET * 1.0e9 * liq_frac ** 3 * dt
    rs = torch.where(liq_frac > 1e-4, r3 ** (1.0 / 3.0), rs_dry)
    return torch.clamp(rs, cfg_snow.rsnw_fall, cfg_snow.rsnw_tmax)


def snow_liquid_budget(dt, *, smice, smliq, Tsno, melts_lyr, frain, fsnow,
                       aicen):
    """Per-layer ice/liquid snow mass: melt turns ice into liquid, cold
    refreezes liquid, rain adds liquid, and liquid above the holding
    capacity (3.3 % of the ice mass) drains."""
    del fsnow
    mask = aicen > cst.puny
    dm_melt = torch.minimum(melts_lyr * cst.rhos, smice)
    smice1 = smice - dm_melt
    smliq1 = smliq + dm_melt + torch.where(mask, frain * dt, 0.0)
    # all liquid refreezes with a timescale of 1 h below -0.1 C
    cold = Tsno < -0.1
    refrz = torch.where(cold, smliq1 * min(dt / 3600.0, 1.0), 0.0)
    smice2 = smice1 + refrz
    smliq2 = smliq1 - refrz
    cap = 0.033 * smice2
    drain = torch.clamp(smliq2 - cap, min=0.0)
    smliq3 = smliq2 - drain
    return (torch.where(mask, smice2, smice),
            torch.where(mask, smliq3, smliq),
            torch.where(mask, drain, 0.0))


def snow_redistribution(cfg_snow, dt, *, vsnon, aicen, alvl, wind):
    """snwredist: blowing-snow transfer from level to deformed ice (a
    fraction snwlvlfac of the level-ice snow moves per day of strong
    wind). Returns (vsnon, the volume lost to leads)."""
    del aicen
    if cfg_snow.snwredist == "none":
        return vsnon, torch.zeros_like(vsnon)
    blow = torch.clamp((wind - cfg_snow.windmin) / 10.0, 0.0, 1.0) * \
        dt / cst.secday
    frac_move = cfg_snow.snwlvlfac * blow
    lvl = torch.clamp(alvl, 0.0, 1.0)
    dv = vsnon * frac_move * lvl
    # the blown fraction lvl*dv is lost to leads (the reference's fsloss)
    lost = dv * lvl
    return vsnon - dv + dv * (1.0 - lvl), lost


def step_snow(cfg, dt, *, vsnon, aicen, trcrn, Tsno, melts, frain, fsnow,
              wind):
    """The snow-physics step: the four snow tracers and vsnon.

    Tsno: top snow layer temperature (ncat, ny, nx); melts: snow melt this
    step (m, per category). Returns (trcrn, meltsliq, vsnon, fsloss) with
    the tracers in a copy of trcrn."""
    if not cfg.tracers.tr_snow:
        zero = torch.zeros_like(aicen)
        return trcrn, zero, vsnon, zero
    trcrn = dict(trcrn)
    nslyr = cfg.domain.nslyr
    smice, smliq = trcrn["smice"], trcrn["smliq"]
    rhos_cmp, rsnw = trcrn["rhos_cmp"], trcrn["rsnw"]

    ice = aicen > cst.puny
    mask3 = ice[:, None]
    hs = torch.where(ice, vsnon / torch.clamp(aicen, min=cst.puny), 0.0)
    hslyr = hs / nslyr
    # default ice content where the tracers are empty (fresh snowfall)
    smice = torch.where(smice > cst.puny, smice,
                        torch.where(mask3, cst.rhos * hslyr[:, None], 0.0))

    smice_n, smliq_n, drain = snow_liquid_budget(
        dt, smice=smice, smliq=smliq, Tsno=Tsno[:, None],
        melts_lyr=melts[:, None] / nslyr, frain=frain[None] / nslyr,
        fsnow=fsnow[None], aicen=aicen[:, None])
    meltsliq = lsum(drain, dim=1)

    # snowpack temperature-gradient proxy: surface at Tsno, base near 0C
    Tgrd = torch.abs(Tsno[:, None]) / torch.clamp(hslyr[:, None] * nslyr,
                                                  min=0.05)
    rsnw_n = grain_metamorphism(cfg.snow, dt, rsnw, Tsno[:, None],
                                smice_n, smliq_n, Tgrd=Tgrd,
                                rhos_eff=snow_effective_density(
                                    cfg.snow, smice_n, smliq_n, rhos_cmp))
    # fresh snowfall resets the top layer radius toward rsnw_fall
    new_frac = clip(fsnow[None] * dt /
                    torch.clamp(cst.rhos * hslyr[:, None], min=cst.puny),
                    0.0, 1.0)
    rsnw_top = rsnw_n.clone()
    rsnw_top[:, 0] = rsnw_n[:, 0] * (1.0 - new_frac[:, 0]) + \
        cfg.snow.rsnw_fall * new_frac[:, 0]

    rhos_n = update_rhos_wind(cfg.snow, dt, rhos_cmp, wind[None])

    vsnon_n = vsnon
    vsn_lost = torch.zeros_like(aicen)
    if cfg.snow.snwredist != "none" and "alvl" in trcrn:
        vsnon_n, vsn_lost = snow_redistribution(
            cfg.snow, dt, vsnon=vsnon, aicen=aicen, alvl=trcrn["alvl"],
            wind=wind)

    trcrn["smice"] = smice_n
    trcrn["smliq"] = smliq_n
    trcrn["rhos_cmp"] = torch.where(mask3, rhos_n, rhos_cmp)
    trcrn["rsnw"] = torch.where(mask3, rsnw_top, rsnw)
    # fsloss (kg/m^2/s per category plane): wind-blown snow to the ocean
    fsloss = cst.rhos * vsn_lost / dt
    return trcrn, meltsliq, vsnon_n, fsloss
