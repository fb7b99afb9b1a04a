"""ITD-coupled thermodynamics: frazil new-ice formation, lateral melt, then
the linear ITD remap / rebin / cleanup (PyTorch port of
cice_tpu/columns/thermo_itd.py; Bitz et al. 2001 ITD model, Steele 1992
lateral melt). Dense over (ncat, ny, nx); category loops unrolled.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .. import constants as cst
from ..ops import lmean, lsum
from .itd import (cleanup_itd, linear_itd_remap, name_offsets, pack_tracers,
                  rebin, unpack_tracers, vicen_safe_h)
from .thermo_vertical import bl99_salinity, enthalpy_ice, melting_temps


class Therm2Out(NamedTuple):
    aicen: torch.Tensor
    vicen: torch.Tensor
    vsnon: torch.Tensor
    trcrn: dict
    frazil: torch.Tensor     # new frazil ice thickness formed (m)
    frz_onset: torch.Tensor
    freshn_frazil: torch.Tensor   # frazil part of freshn
    fsaltn_frazil: torch.Tensor
    fhocn: torch.Tensor      # additional heat to ocean (W/m^2)
    freshn: torch.Tensor     # additional fresh water (kg/m^2/s)
    fsaltn: torch.Tensor     # additional salt (kg/m^2/s)
    meltl: torch.Tensor      # lateral melt (m)
    dpnd_melt: torch.Tensor  # pond water lost with laterally-melted ice (m)


@functools.lru_cache(maxsize=16)
def _salinity_profile(nilyr, dtype, device) -> torch.Tensor:
    """(nilyr, 1, 1) BL99 salinity profile on `device`, built once."""
    return torch.as_tensor(bl99_salinity(nilyr), dtype=dtype,
                           device=device)[:, None, None]


def add_new_ice(aicen, vicen, vsnon, trcrn, *, frzmlt, Tf, dt, hin_max,
                nilyr, registry, sss=None, sal_ref=None):
    """Frazil ice formation in open water: frzmlt > 0 (W/m^2) freezes new
    ice of thickness >= hfrazilmin into the thinnest category, with the
    enthalpy of new ice at the freezing temperature and the initial
    salinity profile. `trcrn` is the tracer dict or the packed
    (ncat, NT, ny, nx) stack."""
    aice = lsum(aicen, dim=0)
    aice0 = torch.clamp(1.0 - aice, 0.0, 1.0)

    efrz = torch.clamp(frzmlt, min=0.0) * dt
    salin = bl99_salinity(nilyr)
    Tm_mean = float(melting_temps(salin).mean())
    qfrz = enthalpy_ice(torch.clamp(Tf, max=Tm_mean - 0.5), Tm_mean)
    vfrz = efrz / torch.clamp(-qfrz, min=1.0)

    ai0 = torch.clamp(aice0, min=cst.puny)
    hnew = torch.clamp(vfrz / ai0, min=cst.hfrazilmin)
    anew = torch.minimum(vfrz / hnew, aice0)
    anew = torch.where(vfrz > cst.puny, anew, 0.0)
    vnew = anew * hnew

    a0, v0 = aicen[0], vicen[0]
    atot = a0 + anew
    wa_old = torch.where(atot > cst.puny,
                         a0 / torch.clamp(atot, min=cst.puny), 1.0)
    wa_new = 1.0 - wa_old
    vtot = v0 + vnew
    wv_old = torch.where(vtot > cst.puny,
                         v0 / torch.clamp(vtot, min=cst.puny), 1.0)
    wv_new = 1.0 - wv_old

    off = name_offsets(registry)
    packed_in = not isinstance(trcrn, dict)
    if packed_in:
        row0 = trcrn[0].clone()          # (NT, ny, nx) category-0 rows
        has = off.__contains__
    else:
        trcrn = dict(trcrn)
        has = trcrn.__contains__

    def get0(name):
        if not packed_in:
            return trcrn[name][0]
        o, n = off[name]
        return row0[o:o + n] if n > 1 else row0[o]

    def set0(name, val0):
        if not has(name):
            return
        if packed_in:
            o, n = off[name]
            row0[o:o + n] = val0 if val0.ndim == 3 else val0[None]
        else:
            new = trcrn[name].clone()
            new[0] = val0
            trcrn[name] = new

    set0("Tsfcn", get0("Tsfcn") * wa_old + Tf * wa_new)
    set0("qice", get0("qice") * wv_old[None] + qfrz * wv_new[None])
    s0 = get0("sice")
    prof = _salinity_profile(nilyr, s0.dtype, s0.device) * torch.ones_like(s0)
    set0("sice", s0 * wv_old[None] + prof * wv_new[None])
    if has("FY"):
        set0("FY", get0("FY") * wa_old + 1.0 * wa_new)
    if has("alvl"):
        set0("alvl", get0("alvl") * wa_old + 1.0 * wa_new)  # level ice
    if has("vlvl"):
        set0("vlvl", get0("vlvl") * wv_old + 1.0 * wv_new)
    if has("iage"):
        set0("iage", get0("iage") * wv_old)      # new ice has age 0
    if has("fbri"):
        set0("fbri", get0("fbri") * wv_old + 1.0 * wv_new)

    if packed_in:
        trcrn = torch.cat([row0[None], trcrn[1:]], dim=0)
    aicen = torch.cat([atot[None], aicen[1:]], dim=0)
    vicen = torch.cat([vtot[None], vicen[1:]], dim=0)

    frazil = vnew
    S_frz = float(salin.mean()) if sal_ref is None else sal_ref
    fsaltn = -cst.rhoi * vnew * S_frz * 1e-3 / dt
    freshn = -cst.rhoi * vnew / dt
    return aicen, vicen, trcrn, frazil, freshn, fsaltn


def lateral_melt(aicen, vicen, vsnon, trcrn, *, frzmlt, Tbot, sst, Tf, dt,
                 registry, floediam=300.0, alpha=0.66, sal_ref=None):
    """Lateral melt of floe edges (Steele 1992): melt rate
    wlat = m1 * (sst - Tf)^m2 (Maykut & Perovich 1987), rside = fraction of
    floe perimeter melted = wlat*dt*pi/(alpha*floediam). Only active when
    frzmlt < 0 (melting potential)."""
    m1, m2 = 1.6e-6, 1.36
    deltaT = torch.clamp(sst - Tf, min=0.0)
    wlat = m1 * deltaT ** m2
    rside = torch.clamp(wlat * dt * math.pi / (alpha * floediam), 0.0, 1.0)
    rside = torch.where(frzmlt < 0.0, rside, 0.0)

    dt_i = 1.0 / dt
    vice_rm = lsum(vicen, dim=0) * rside
    vsno_rm = lsum(vsnon, dim=0) * rside
    if isinstance(trcrn, dict):
        qice = trcrn["qice"]
        qsno = trcrn["qsno"]
    else:
        off = name_offsets(registry)
        o, n = off["qice"]
        qice = trcrn[:, o:o + n]
        o, n = off["qsno"]
        qsno = trcrn[:, o:o + n]
    nilyr = qice.shape[1]
    eice = lsum(lmean(qice, 1) * vicen, dim=0) * rside   # J/m^2 (<0)
    esno = lsum(lmean(qsno, 1) * vsnon, dim=0) * rside
    fhocn = (eice + esno) * dt_i
    freshn = (cst.rhoi * vice_rm + cst.rhos * vsno_rm) * dt_i
    salin = bl99_salinity(nilyr)
    S_lat = float(salin.mean()) if sal_ref is None else sal_ref
    fsaltn = cst.rhoi * vice_rm * S_lat * 1e-3 * dt_i

    factor = 1.0 - rside
    aicen = aicen * factor[None]
    vicen = vicen * factor[None]
    vsnon = vsnon * factor[None]
    return aicen, vicen, vsnon, vice_rm, fhocn, freshn, fsaltn


def step_therm2(cfg, grid, aicen, vicen, vsnon, trcrn, *, hicen_old,
                frzmlt, Tf, sst, dt, hin_max, registry) -> Therm2Out:
    """ITD remap + rebin, lateral melt, frazil, rebin + cleanup; the whole
    chain runs on one packed (ncat, NT, ny, nx) tracer stack."""
    nilyr = cfg.domain.nilyr

    off = name_offsets(registry)
    trp = pack_tracers(trcrn, registry)

    if cfg.thermo.kitd == 1:
        hicen_new = vicen_safe_h(vicen, aicen)
        aicen, vicen, vsnon, trp = linear_itd_remap(
            aicen, vicen, vsnon, trp, hin_max, hicen_old, hicen_new,
            registry)
    aicen, vicen, vsnon, trp = rebin(aicen, vicen, vsnon, trp, hin_max,
                                     registry)

    # salt fluxes at ice_ref_salinity under saltflux_option='constant'
    sal_ref = (cfg.thermo.ice_ref_salinity
               if cfg.thermo.saltflux_option == "constant" else None)
    # pond water riding on the laterally-melted area drains to the ocean
    if "apnd" in off and "hpnd" in off:
        pond_h = torch.clamp(trp[:, off["apnd"][0]], 0.0, 1.0) \
            * torch.clamp(trp[:, off["hpnd"][0]], min=0.0)
        pond_vol0 = lsum(aicen * pond_h, dim=0)
    else:
        pond_h = pond_vol0 = None

    aicen, vicen, vsnon, meltl, fhocn_l, fresh_l, fsalt_l = lateral_melt(
        aicen, vicen, vsnon, trp, frzmlt=frzmlt, Tbot=Tf, sst=sst, Tf=Tf,
        dt=dt, registry=registry, sal_ref=sal_ref)
    if pond_vol0 is not None:
        pond_vol1 = lsum(aicen * pond_h, dim=0)
        dpnd_melt = torch.clamp(pond_vol0 - pond_vol1, min=0.0)
    else:
        dpnd_melt = torch.zeros_like(meltl)

    aicen, vicen, trp, frazil, fresh_f, fsalt_f = add_new_ice(
        aicen, vicen, vsnon, trp, frzmlt=frzmlt, Tf=Tf, dt=dt,
        hin_max=hin_max, nilyr=nilyr, registry=registry, sal_ref=sal_ref)

    aicen, vicen, vsnon, trp = rebin(aicen, vicen, vsnon, trp, hin_max,
                                     registry)
    aicen, vicen, vsnon, trp, fclean = cleanup_itd(
        aicen, vicen, vsnon, trp, registry, dt=dt,
        sal_ref=(sal_ref if sal_ref is not None
                 else cfg.thermo.ice_ref_salinity))
    trcrn = unpack_tracers(trp, registry)

    frz_onset = (frazil > 0.0).to(frazil.dtype)
    return Therm2Out(aicen=aicen, vicen=vicen, vsnon=vsnon, trcrn=trcrn,
                     frazil=frazil, frz_onset=frz_onset,
                     fhocn=fhocn_l + fclean["fhocn"],
                     freshn=fresh_l + fresh_f + fclean["fresh"],
                     fsaltn=fsalt_l + fsalt_f + fclean["fsalt"], meltl=meltl,
                     freshn_frazil=fresh_f, fsaltn_frazil=fsalt_f,
                     dpnd_melt=dpnd_melt)
