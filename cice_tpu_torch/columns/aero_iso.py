"""Aerosol and water-isotope tracers in snow and ice (PyTorch port of
cice_tpu/columns/aero_iso.py; reference icepack_aerosol/icepack_isotope
inside icepack_step_therm1, tracer_nml tr_aero/tr_iso, deposition
defaults faero_default/fiso_default in ice_forcing_bgc.F90:726).

Atmospheric deposition into the snow (or bare-ice) surface layer, meltwater
scavenging to the ocean with per-species scavenging ratios, and snow-to-ice
transfer on snow-ice formation. A species is a few elementwise operations,
so the species loops stay loops.

Tracer layout (the registry in model/state.py):
  aerosno (ncat, 2*n_aero, ny, nx): kg/m^2 in [snow SSL, snow int] per species
  aeroice (ncat, 2*n_aero, ny, nx): kg/m^2 in [ice SSL, ice int]
  isosno / isoice (ncat, n_iso, ny, nx): kg/m^2 water-isotope mass
"""

from __future__ import annotations

import torch

from .. import constants as cst

# scavenging ratios per aerosol species (fraction of the layer burden
# removed per unit fractional melt; icepack kscav defaults: BC, BC, dust x4)
KSCAV = (0.03, 0.20, 0.02, 0.02, 0.01, 0.01)

# default deposition rates (kg/m^2/s) for standalone runs (faero_default)
FAERO_DEFAULT = (1.0e-12, 1.0e-13, 1.0e-11)

# isotope fractionation factors at deposition (HDO, H218O vs H216O)
ALPHA_DEP = (1.0, 0.98, 0.985)


def _dep_amount(mask, dep, dt, dtype):
    """where(mask, dep * dt, 0) for a (ny, nx) rate tensor or a Python
    rate (then the 0/1 mask times the scalar: exact, in `dtype`)."""
    if isinstance(dep, torch.Tensor):
        return torch.where(mask, dep * dt, 0.0)
    return mask.to(dtype) * (dep * dt)


def step_aerosols(cfg, dt, *, aicen, vicen, vsnon, aerosno, aeroice,
                  melts, meltt, snoice, fsnow, faero_atm=None):
    """One aerosol step for all species and categories. melts/meltt: snow
    and top-ice melt (m); snoice: snow-ice formation (m). Returns (aerosno,
    aeroice, faero_ocn), faero_ocn (n_aero, ny, nx) the flux to the ocean
    (kg/m^2/s)."""
    del fsnow
    n_aero = cfg.domain.n_aero
    if n_aero == 0:
        return aerosno, aeroice, aicen.new_zeros((0,) + aicen.shape[1:])
    mask = aicen > cst.puny
    am = torch.clamp(aicen, min=cst.puny)
    hs = torch.where(mask, vsnon / am, 0.0)
    hi = torch.where(mask, vicen / am, 0.0)
    has_snow = hs > cst.puny
    m_snow = mask & has_snow
    m_bare = mask & ~has_snow
    fmelt_s = torch.clamp(melts / torch.clamp(hs, min=0.05), 0.0, 1.0)
    fmelt_i = torch.clamp(meltt / torch.clamp(hi, min=0.05), 0.0, 1.0)
    fsi = torch.clamp(snoice / torch.clamp(hs, min=0.05), 0.0, 1.0)

    sn = list(aerosno.unbind(1))
    ic = list(aeroice.unbind(1))
    faero_ocn = []
    for a in range(n_aero):
        dep = (faero_atm[a] if faero_atm is not None
               else FAERO_DEFAULT[min(a, len(FAERO_DEFAULT) - 1)])
        kscav = KSCAV[min(a, len(KSCAV) - 1)]
        i_ssl, i_int = 2 * a, 2 * a + 1
        # deposition into the snow SSL (bare ice: into the ice SSL)
        sn_ssl = sn[i_ssl] + _dep_amount(m_snow, dep, dt, aicen.dtype)
        ic_ssl = ic[i_ssl] + _dep_amount(m_bare, dep, dt, aicen.dtype)
        sn_int = sn[i_int]
        ic_int = ic[i_int]
        # meltwater scavenging: fractional melt of snow / top ice removes
        # kscav * burden fraction to the ocean
        rm_s = kscav * fmelt_s * (sn_ssl + sn_int)
        rm_i = kscav * fmelt_i * (ic_ssl + ic_int)
        tot_s = torch.clamp(sn_ssl + sn_int, min=cst.puny)
        sn_ssl = sn_ssl - rm_s * sn_ssl / tot_s
        sn_int = sn_int - rm_s * sn_int / tot_s
        tot_i = torch.clamp(ic_ssl + ic_int, min=cst.puny)
        ic_ssl = ic_ssl - rm_i * ic_ssl / tot_i
        ic_int = ic_int - rm_i * ic_int / tot_i
        # snow-ice formation moves the snow interior burden into the ice SSL
        xfer = fsi * sn_int
        sn_int = sn_int - xfer
        ic_ssl = ic_ssl + xfer
        sn[i_ssl] = torch.where(mask, sn_ssl, sn[i_ssl])
        sn[i_int] = torch.where(mask, sn_int, sn[i_int])
        ic[i_ssl] = torch.where(mask, ic_ssl, ic[i_ssl])
        ic[i_int] = torch.where(mask, ic_int, ic[i_int])
        faero_ocn.append(torch.sum(torch.where(mask, aicen * (rm_s + rm_i),
                                               0.0), dim=0) / dt)
    return (torch.stack(sn, dim=1), torch.stack(ic, dim=1),
            torch.stack(faero_ocn))


def step_isotopes(cfg, dt, *, aicen, vsnon, isosno, isoice, fsnow, melts,
                  snoice, fiso_atm=None):
    """Water-isotope budget: snowfall deposition with species
    fractionation (or the coupler's per-species rates `fiso_atm`), melt
    release to the ocean, snow-ice transfer. Returns (isosno, isoice,
    fiso_ocn)."""
    n_iso = cfg.domain.n_iso
    if n_iso == 0:
        return isosno, isoice, aicen.new_zeros((0,) + aicen.shape[1:])
    mask = aicen > cst.puny
    hs = torch.where(mask, vsnon / torch.clamp(aicen, min=cst.puny), 0.0)
    hs5 = torch.clamp(hs, min=0.05)
    fmelt_s = torch.clamp(melts / hs5, 0.0, 1.0)
    fsi = torch.clamp(snoice / hs5, 0.0, 1.0)
    sn = list(isosno.unbind(1))
    ic = list(isoice.unbind(1))
    fiso_ocn = []
    for k in range(n_iso):
        alpha = ALPHA_DEP[min(k, len(ALPHA_DEP) - 1)]
        if fiso_atm is not None and fiso_atm.shape[0] > k:
            dep = torch.where(mask, fiso_atm[k] * dt, 0.0)
        else:
            dep = torch.where(mask, alpha * fsnow * dt, 0.0)
        s = sn[k] + dep
        i = ic[k]
        rel = fmelt_s * s
        s = s - rel
        xfer = fsi * s
        s = s - xfer
        i = i + xfer
        sn[k] = torch.where(mask, s, sn[k])
        ic[k] = torch.where(mask, i, ic[k])
        fiso_ocn.append(torch.sum(torch.where(mask, aicen * rel, 0.0),
                                  dim=0) / dt)
    return (torch.stack(sn, dim=1), torch.stack(ic, dim=1),
            torch.stack(fiso_ocn))
