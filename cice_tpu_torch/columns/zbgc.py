"""Biogeochemistry of the skeletal layer: bottom ice algae and nutrients
(PyTorch port of cice_tpu/columns/zbgc.py; reference
icepack_biogeochemistry with zbgc_nml skl_bgc, ice_step_mod.F90:1634-1782).

Biology lives in the bottom SK_L of the ice (Jin et al. 2006; Deal et al.
2011): algal growth limited by light and nutrients with a temperature
dependence, grazing and mortality, nutrient uptake and remineralisation,
and ice-ocean exchange through a molecular-sublayer piston velocity. The
network's loops run over algal classes and pools, whose counts the
configuration fixes.

Tracers per category (ncat, ny, nx): algae and particulates in mmol/m^2,
dissolved pools in mmol/m^3 of the skeletal layer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as cst
from ..ops import lsum

SK_L = 0.03            # skeletal layer thickness (m)
CHLABS = 0.03          # light attenuation per algal biomass


class BgcOut(NamedTuple):
    bgc_N: torch.Tensor
    bgc_Nit: torch.Tensor
    flux_NO3_ocn: torch.Tensor  # net nitrate flux to ocean (mmol/m^2/s)
    grow_net: torch.Tensor      # net specific growth (1/s)


def _piston_velocity(cfg_bgc, congel, meltb, dt):
    """Skeletal-layer exchange velocity (zbgc_nml bgc_flux_type):
    'constant' gives pv0/secday; 'Jin2006' enhances it with the ice
    bottom's growth or melt rate."""
    pv0 = cfg_bgc.pv0 / cst.secday
    if cfg_bgc.bgc_flux_type != "Jin2006":
        return pv0
    wb = (torch.abs(congel) + torch.abs(meltb)) / dt     # m/s
    return pv0 * (0.5 + torch.clamp(wb / 8.0e-7, 0.0, 9.5))


def step_bgc_skl(cfg_bgc, dt, *, aicen, vicen, bgc_N, bgc_Nit, fswthru,
                 Tbot, meltb, congel, nit_ocn):
    """One step of the two-tracer skeletal model (algal N and nitrate),
    dense over (ncat, ny, nx). fswthru: SW reaching the ice bottom (W/m^2);
    Tbot (degC); meltb/congel: bottom melt/growth this step (m); nit_ocn:
    mixed-layer nitrate (mmol/m^3)."""
    del vicen
    mask = aicen > cst.puny
    par = 0.45 * torch.clamp(fswthru, min=0.0) * torch.exp(-CHLABS * bgc_N)
    L_lim = par / (par + cfg_bgc.chlabs_par_half)
    N_lim = bgc_Nit / (bgc_Nit + cfg_bgc.K_Nit)
    Tfac = torch.exp(0.0633 * torch.clamp(Tbot, max=0.0))

    mu = cfg_bgc.mu_max / cst.secday * torch.minimum(L_lim, N_lim) * Tfac
    grow = mu * bgc_N * dt
    # the layer cannot give more nitrogen than it holds
    grow = torch.minimum(grow, 0.9 * bgc_Nit * SK_L)

    loss = (cfg_bgc.fr_graze + cfg_bgc.mort_pre) / cst.secday * bgc_N * dt
    loss = torch.minimum(loss, bgc_N + grow)
    remin = cfg_bgc.fr_resp * loss

    N_new = bgc_N + grow - loss
    Nit_new = bgc_Nit + (remin - grow) / SK_L

    # bottom melt releases biomass
    frel = torch.clamp(meltb / SK_L, 0.0, 1.0)
    released = frel * N_new
    N_new = N_new - released

    # ice-ocean nutrient exchange
    pv = _piston_velocity(cfg_bgc, congel, meltb, dt)
    dNit = pv * (nit_ocn - Nit_new) * dt / SK_L
    Nit_new = Nit_new + dNit

    N_new = torch.where(mask, torch.clamp(N_new, min=0.0), 0.0)
    Nit_new = torch.where(mask, torch.clamp(Nit_new, min=0.0),
                          torch.broadcast_to(nit_ocn, bgc_Nit.shape))
    flux = lsum(torch.where(mask, aicen * (released - dNit * SK_L),
                                 0.0), dim=0) / dt
    return BgcOut(bgc_N=N_new, bgc_Nit=Nit_new, flux_NO3_ocn=flux,
                  grow_net=torch.where(mask, mu, 0.0))


# stoichiometry (Elliott et al. 2012; icepack defaults)
R_SI2N = (1.8, 0.0, 0.0)       # silicate:N uptake per algal class
R_S2N = (0.03, 0.03, 0.03)     # DMSP sulfur per algal N
R_C2N = 7.0                    # carbon:N (mol)
ALGAL_CLASSES = ("bgc_N", "bgc_N2", "bgc_N3")   # diatoms, small phyto, Phaeo


def _minimum(a: torch.Tensor, b) -> torch.Tensor:
    """Elementwise minimum of a tensor and a tensor or Python scalar."""
    return torch.minimum(a, b) if isinstance(b, torch.Tensor) \
        else torch.clamp(a, max=b)


class BgcNetOut(NamedTuple):
    trc: dict                   # updated bgc tracers (the input's keys)
    flux_bgc_ocn: dict          # name -> net flux to ocean (mmol/m^2/s)
    grow_net: torch.Tensor      # net specific growth (1/s)
    upNO: torch.Tensor          # algal NO3 uptake (mmol N/m^2/s)
    upNH: torch.Tensor          # algal NH4 uptake (mmol N/m^2/s)
    PP_net: torch.Tensor        # net primary production (mg C/m^2/d)


def step_bgc_skl_net(cfg_bgc, dt, *, aicen, trc, fswthru, Tbot, meltb,
                     congel, ocean):
    """One step of the full skeletal-layer network, dense over (ncat, ny,
    nx). `trc` holds whichever bgc tracers are registered: algae
    bgc_N[,2,3], dissolved pools (bgc_Nit, Am, Sil, DMSPd, DMS, DON, DOC*,
    DIC*, Fed*, hum), particulates (bgc_DMSPp, PON, Fep*). `ocean` maps a
    dissolved tracer's name to its mixed-layer concentration (a Python
    float)."""
    mask = aicen > cst.puny
    out = dict(trc)
    secday = cst.secday
    Tfac = torch.exp(0.0633 * torch.clamp(Tbot, max=0.0))
    frel = torch.clamp(meltb / SK_L, 0.0, 1.0)
    pv = _piston_velocity(cfg_bgc, congel, meltb, dt)
    fluxes = {}

    def to_ocean(x):
        return lsum(torch.where(mask, aicen * x, 0.0), dim=0) / dt

    # total algal biomass for self-shading
    Ntot = sum(trc[a] for a in ALGAL_CLASSES if a in trc)
    par = 0.45 * torch.clamp(fswthru, min=0.0) * torch.exp(-CHLABS * Ntot)
    L_lim = par / (par + cfg_bgc.chlabs_par_half)

    Nit = trc.get("bgc_Nit")
    Am = trc.get("bgc_Am")
    Sil = trc.get("bgc_Sil")

    tot_upNit = 0.0     # mmol N/m^2 taken from nitrate this step
    tot_upAm = 0.0
    tot_upSil = 0.0
    tot_mort = 0.0      # algal losses to the detritus and dissolved pools
    grow_net = torch.zeros_like(aicen)

    for ia, name in enumerate(ALGAL_CLASSES):
        if name not in trc:
            continue
        Nalg = trc[name]
        # Liebig limitation over the available nutrients
        N_pool = Nit if Nit is not None else cfg_bgc.nit_data
        if Am is not None:
            N_pool = N_pool + Am
        N_lim = N_pool / (N_pool + cfg_bgc.K_Nit)
        lim = _minimum(L_lim, N_lim)
        if R_SI2N[ia] > 0.0 and Sil is not None:
            lim = torch.minimum(lim, Sil / (Sil + cfg_bgc.K_Sil))
        mu = cfg_bgc.mu_max / secday * lim * Tfac
        grow = mu * Nalg * dt
        grow = _minimum(grow, 0.9 * N_pool * SK_L)
        # ammonium is taken first
        upAm = torch.minimum(grow, 0.9 * Am * SK_L) if Am is not None \
            else 0.0
        upNit = grow - upAm
        loss = (cfg_bgc.fr_graze + cfg_bgc.mort_pre) / secday * Nalg * dt
        loss = torch.minimum(loss, Nalg + grow)
        Nnew = Nalg + grow - loss
        released = frel * Nnew
        out[name] = torch.where(mask, torch.clamp(Nnew - released, min=0.0),
                                0.0)
        fluxes[name] = to_ocean(released)
        tot_upNit = tot_upNit + upNit
        tot_upAm = tot_upAm + upAm
        tot_upSil = tot_upSil + R_SI2N[ia] * grow
        tot_mort = tot_mort + loss
        grow_net = grow_net + torch.where(mask, mu, 0.0)
        # the sulfur cycle rides on algal growth and mortality
        if "bgc_DMSPp" in trc:
            out["bgc_DMSPp"] = out["bgc_DMSPp"] + R_S2N[ia] * (grow - loss)

    def dissolved(name, source_per_area, uptake_per_area):
        """A dissolved pool (mmol/m^3 of the layer): in-ice source and
        sink, then molecular-sublayer exchange with the ocean."""
        C = out[name]
        C = C + (source_per_area - uptake_per_area) / SK_L
        ocn = ocean.get(name, 0.0)
        dC = pv * (ocn - C) * dt / SK_L
        C = C + dC
        out[name] = torch.where(mask, torch.clamp(C, min=0.0), ocn)
        fluxes[name] = lsum(torch.where(mask, -aicen * dC * SK_L, 0.0),
                                 dim=0) / dt

    remin = cfg_bgc.fr_resp * tot_mort          # N remineralised in place
    to_PON = (1.0 - cfg_bgc.fr_resp) * tot_mort

    if Am is not None:
        # remineralisation feeds ammonium; nitrification drains it to NO3
        nitrif = cfg_bgc.k_nitrif / secday * Am * SK_L * dt
        dissolved("bgc_Am", remin, tot_upAm + nitrif)
    else:
        nitrif = remin                           # straight to nitrate
    if Nit is not None:
        dissolved("bgc_Nit", nitrif, tot_upNit)
    if Sil is not None:
        dissolved("bgc_Sil", 0.0, tot_upSil)

    if "bgc_PON" in trc:
        PON = out["bgc_PON"] + to_PON
        rel = frel * PON
        out["bgc_PON"] = torch.where(mask, torch.clamp(PON - rel, min=0.0),
                                     0.0)
        fluxes["bgc_PON"] = to_ocean(rel)

    if "bgc_DON" in trc:
        # a fraction of the losses dissolves; slow remineralisation
        don_src = cfg_bgc.f_don * tot_mort
        don_sink = cfg_bgc.kn_bac / secday * out["bgc_DON"] * SK_L * dt
        dissolved("bgc_DON", don_src, don_sink)

    if "bgc_DMSPp" in trc:
        # particulate DMSP lysis -> dissolved DMSPd
        DMSPp = torch.clamp(out["bgc_DMSPp"], min=0.0)
        lysis = dt / (cfg_bgc.t_sk_conv * secday) * DMSPp
        relp = frel * (DMSPp - lysis)
        out["bgc_DMSPp"] = torch.where(
            mask, torch.clamp(DMSPp - lysis - relp, min=0.0), 0.0)
        fluxes["bgc_DMSPp"] = to_ocean(relp)
        if "bgc_DMSPd" in trc:
            # DMSPd -> DMS with a yield fraction
            conv = dt / (cfg_bgc.t_sk_conv * secday) * \
                out["bgc_DMSPd"] * SK_L
            dissolved("bgc_DMSPd", lysis, conv)
            if "bgc_DMS" in trc:
                ox = dt / (cfg_bgc.t_sk_ox * secday) * out["bgc_DMS"] * SK_L
                dissolved("bgc_DMS", cfg_bgc.y_sk_DMS * conv, ox)

    # carbon: spilled algal losses feed the DOC classes, bacterial
    # degradation respires a fraction back to DIC, photosynthesis draws
    # DIC down by C:N times the realised N uptake
    if "bgc_DOC1" in trc:
        f_doc = (cfg_bgc.f_doc_s, cfg_bgc.f_doc_l,
                 max(1.0 - cfg_bgc.f_doc_s - cfg_bgc.f_doc_l, 0.0))
        kn_doc = (cfg_bgc.kn_bac_s, cfg_bgc.kn_bac_l, cfg_bgc.kn_bac_s)
        c_spill = R_C2N * tot_mort
        doc_resp = 0.0
        for i in range(3):
            nm = f"bgc_DOC{i+1}"
            if nm not in trc:
                continue
            rem = kn_doc[i] / secday * torch.clamp(out[nm], min=0.0) * \
                SK_L * dt
            dissolved(nm, f_doc[i] * c_spill, rem)
            doc_resp = doc_resp + getattr(cfg_bgc, "fr_resp_s", 1.0) * rem
        if "bgc_DIC1" in trc:
            dissolved("bgc_DIC1", doc_resp, R_C2N * (tot_upNit + tot_upAm))

    # humic matter: a passive dissolved pool, ocean exchange only
    if "bgc_hum" in trc:
        dissolved("bgc_hum", 0.0, 0.0)

    # iron: each dissolved class scavenges onto its particulate partner;
    # particulates leave with bottom melt
    for suf in ("", "2"):
        fd, fp = "bgc_Fed" + suf, "bgc_Fep" + suf
        if fd in trc:
            fed_sink = cfg_bgc.k_fe_scav / secday * out[fd] * SK_L * dt
            dissolved(fd, 0.0, fed_sink)
        else:
            fed_sink = 0.0
        if fp in trc:
            Fep = out[fp] + fed_sink
            rel = frel * Fep
            out[fp] = torch.where(mask, torch.clamp(Fep - rel, min=0.0), 0.0)
            fluxes[fp] = to_ocean(rel)

    z = torch.zeros_like(aicen)
    upNO = tot_upNit / dt if isinstance(tot_upNit, torch.Tensor) else z
    upNH = tot_upAm / dt if isinstance(tot_upAm, torch.Tensor) else z
    PP_net = (upNO + upNH) * R_C2N * 12.0 * secday
    return BgcNetOut(trc=out, flux_bgc_ocn=fluxes, grow_net=grow_net,
                     upNO=upNO, upNH=upNH, PP_net=PP_net)
