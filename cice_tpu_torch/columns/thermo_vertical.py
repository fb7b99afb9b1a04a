"""Vertical thermodynamics: BL99 multi-layer conduction + growth/melt,
with the mushy-layer (ktherm=2) state relations of columns/mushy.py in the
same solve (PyTorch port of cice_tpu/columns/thermo_vertical.py).

Bitz & Lipscomb (1999) brine-pocket heat capacity, implicit conduction solve
and congelation/melt bookkeeping; Maykut & Untersteiner (1971) salinity
profile and conductivity. All functions are dense over (..., ny, nx) with the
layer loops unrolled in Python (nilyr, nslyr static).

Sign conventions: fluxes positive downward; enthalpies negative (energy
required to melt); temperatures in degC.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants as cst
from ..ops import clip

TSF_ERRMAX = 5.0e-4   # Picard exit: largest temperature change anywhere (K)


# ---------------------------------------------------------------------------
# salinity / melting-temperature profiles (BL99 / MU71)
# ---------------------------------------------------------------------------

def bl99_salinity(nilyr: int) -> np.ndarray:
    """Fixed BL99 salinity profile (psu) at layer midpoints:
    S(z) = (saltmax/2) [1 - cos(pi z^(nsal/(msal+z)))], z = (k-1/2)/nilyr."""
    z = (np.arange(nilyr) + 0.5) / nilyr
    return 0.5 * cst.saltmax * (1.0 - np.cos(
        np.pi * z ** (cst.nsal / (cst.msal + z))))


def melting_temps(salin):
    """Layer melting temperature Tm = -depressT * S (degC)."""
    return -cst.depressT * salin


# ---------------------------------------------------------------------------
# enthalpy <-> temperature (BL99 forms)
# ---------------------------------------------------------------------------

def enthalpy_ice(T: torch.Tensor, Tm: float) -> torch.Tensor:
    """q_ice(T) (J/m^3), T<Tm<=0: sensible + brine latent + ocean part."""
    Ts = torch.clamp(T, max=Tm - 1e-6)
    return -cst.rhoi * (cst.cp_ice * (Tm - Ts)
                        + cst.Lfresh * (1.0 - Tm / Ts) - cst.cp_ocn * Tm)


def enthalpy_snow(T: torch.Tensor) -> torch.Tensor:
    return -cst.rhos * (cst.Lfresh - cst.cp_ice * T)


def temp_from_enthalpy_ice(q, Tm: float):
    """Invert q_ice(T): quadratic aT^2 + bT + c = 0."""
    a = cst.cp_ice
    b = (cst.cp_ocn - cst.cp_ice) * Tm - q / cst.rhoi - cst.Lfresh
    c = cst.Lfresh * Tm
    disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
    T = (-b - torch.sqrt(disc)) / (2.0 * a)
    return torch.clamp(T, max=Tm)


def temp_from_enthalpy_snow(q):
    return torch.clamp((q / cst.rhos + cst.Lfresh) / cst.cp_ice, max=0.0)


def conductivity_ice(salin: float, T, conduct: str = "bubbly"):
    """Thermal conductivity (W/m/K). MU71: k = kice + betak S/T; 'bubbly'
    (Pringle et al. 2007): k = (2.11 - 0.011 T + 0.09 S/T) rhoi/917."""
    Ts = torch.clamp(T, max=-0.1)
    if conduct == "MU71":
        k = cst.kice + cst.betak * salin / Ts
    else:
        k = (2.11 - 0.011 * Ts + 0.09 * salin / Ts) * (cst.rhoi / 917.0)
    return torch.clamp(k, min=cst.kimin)


def tridiag_solve(sbdiag, diag, spdiag, rhs):
    """Solve per grid cell the tridiagonal system; each argument is a list
    of (..., ny, nx) tensors of equal length (Thomas elimination)."""
    n = len(diag)
    wbeta = [None] * n
    wgamma = [None] * n
    wbeta[0] = diag[0]
    wgamma[0] = rhs[0] / wbeta[0]
    for k in range(1, n):
        m = sbdiag[k] / wbeta[k - 1]
        wbeta[k] = diag[k] - m * spdiag[k - 1]
        wgamma[k] = (rhs[k] - m * wgamma[k - 1] * wbeta[k - 1]) / wbeta[k]
    x = [None] * n
    x[n - 1] = wgamma[n - 1]
    for k in range(n - 2, -1, -1):
        x[k] = wgamma[k] - spdiag[k] / wbeta[k] * x[k + 1]
    return x


# ---------------------------------------------------------------------------
# temperature solve (BL99 temperature_changes)
# ---------------------------------------------------------------------------

class TempSolveOut(NamedTuple):
    Tsf: torch.Tensor
    Tsno: list          # [nslyr] layer temperatures
    Tice: list          # [nilyr]
    fsurf: torch.Tensor      # net downward surface flux at final Tsf
    fcondtop: torch.Tensor   # downward conduction at surface
    fcondbot: torch.Tensor   # downward conduction at ice bottom
    fsens: torch.Tensor
    flat: torch.Tensor
    flwout: torch.Tensor
    einit: torch.Tensor      # initial column energy (J/m^2)
    efinal: torch.Tensor
    keff_top: torch.Tensor   # surface-to-top-layer conductance (W/m^2/K)


def temperature_changes(dt, nilyr, nslyr, *, Tsf, qsno, qice, salin, Tm,
                        hilyr, hslyr, Tbot, fswsfc, Iswabs,
                        shcoef, lhcoef, potT, Qa, rhoa, flw,
                        conduct="bubbly", nit=20, ktherm=1):
    """Implicit BL99 conduction solve, dense over any leading batch dims.

    qsno/qice: lists of layer enthalpies (J/m^3); hilyr/hslyr layer
    thicknesses (m); Tbot: bottom boundary temperature (degC, = Tf).
    The Picard iteration stops when the largest temperature change anywhere
    falls under TSF_ERRMAX or after `nit` passes: the exit test is global,
    so every column takes the same number of passes, read on the host once
    per pass. Returns (TempSolveOut, qsno_new, qice_new).
    """
    from .atmo import surface_fluxes

    mushy = ktherm == 2
    if mushy:
        from . import mushy as mush

    # snow-present mask: hsn > hs_min. A puny threshold lets hs ~ 1e-10
    # through, whose 1/hslyr conductances overflow the f32 elimination
    snow = hslyr * nslyr > cst.hs_min
    snow_f = snow.to(Tsf.dtype)

    Tsn0 = [temp_from_enthalpy_snow(q) for q in qsno]
    if mushy:
        Tin0 = [mush.temperature_mush(qice[k], salin[k])
                for k in range(nilyr)]
    else:
        Tin0 = [temp_from_enthalpy_ice(qice[k], Tm[k])
                for k in range(nilyr)]
    Tsf = torch.clamp(Tsf, -100.0, 0.0)   # [Tmin, Tsmelt] physical window

    einit = sum(q * hslyr for q in qsno) + sum(q * hilyr for q in qice)
    ks = cst.ksno
    hslyr_p = torch.clamp(hslyr, min=cst.puny)
    n_lay = nslyr + nilyr

    def conductivities(Tin):
        if mushy:
            return [mush.conductivity_mush(Tin[k], salin[k])
                    for k in range(nilyr)]
        return [conductivity_ice(salin[k], Tin[k], conduct)
                for k in range(nilyr)]

    def body(Tsf, Tsn, Tin):
        ki = conductivities(Tin)
        # interface conductances (W/m^2/K). Without snow the snow rows
        # become massless conducting nodes whose series conductance from
        # Tsf to the first ice midpoint equals 2*ki0/hilyr, so one dense
        # matrix shape serves every cell.
        khi_sfc = 2.0 * ki[0] / hilyr
        kh_virt = (nslyr + 1.0) * khi_sfc
        khs_sfc = 2.0 * ks / hslyr_p
        kh_ss = ks / hslyr_p
        kh_si_s = 2.0 * ks * ki[0] / torch.clamp(
            ks * hilyr + ki[0] * hslyr, min=cst.puny)
        kh_sfc = torch.where(snow, khs_sfc, kh_virt)
        kh_snow = torch.where(snow, kh_ss, kh_virt)
        kh_si = torch.where(snow, kh_si_s, kh_virt)
        kh_ii = [2.0 * ki[k] * ki[k + 1] / (ki[k] * hilyr + ki[k + 1] * hilyr)
                 for k in range(nilyr - 1)]
        kh_bot = 2.0 * ki[-1] / hilyr

        etas = torch.where(snow, dt / (cst.rhos * cst.cp_ice * hslyr_p), 0.0)
        if mushy:
            ci = [mush.eff_heat_capacity_mush(Tin[k], Tin0[k], salin[k])
                  for k in range(nilyr)]
        else:
            ci = [cst.cp_ice - cst.Lfresh * Tm[k] /
                  torch.clamp(Tin[k] * Tin0[k], min=1e-8)
                  for k in range(nilyr)]
        etai = [dt / (cst.rhoi * torch.clamp(ci[k], min=cst.cp_ice * 0.01)
                      * hilyr) for k in range(nilyr)]

        fsurf, dfsurf, _, _, _ = surface_fluxes(
            Tsf, shcoef, lhcoef, potT, Qa, rhoa, flw, fswsfc)

        # rows: [Tsf, snow layers, ice layers]; bottom Dirichlet Tbot
        nrow = 1 + n_lay
        sb = [None] * nrow
        dg = [None] * nrow
        sp = [None] * nrow
        rh = [None] * nrow
        dg[0] = dfsurf - kh_sfc
        sp[0] = kh_sfc
        rh[0] = dfsurf * Tsf - fsurf
        for k in range(nslyr):
            up = kh_sfc if k == 0 else kh_snow
            dn = kh_si if k == nslyr - 1 else kh_snow
            r = 1 + k
            sb[r] = -etas * up - torch.where(snow, 0.0, up)
            dg[r] = snow_f + etas * (up + dn) \
                + torch.where(snow, 0.0, up + dn)
            sp[r] = -etas * dn - torch.where(snow, 0.0, dn)
            rh[r] = torch.where(snow, Tsn0[k], 0.0)
        for k in range(nilyr):
            r = 1 + nslyr + k
            up = kh_si if k == 0 else kh_ii[k - 1]
            dn = kh_bot if k == nilyr - 1 else kh_ii[k]
            sb[r] = -etai[k] * up
            dg[r] = 1.0 + etai[k] * (up + dn)
            sp[r] = -etai[k] * dn
            rh[r] = Tin0[k] + etai[k] * Iswabs[k]
            if k == nilyr - 1:
                rh[r] = rh[r] + etai[k] * dn * Tbot

        # The layer system is linear in the surface temperature: one
        # bottom-up elimination gives x_k = alpha_k + beta_k * x_{k-1} and
        # serves both the cold and the melting surface closure.
        alpha = [None] * (n_lay + 1)
        beta = [None] * (n_lay + 1)
        for k in range(n_lay, 0, -1):
            denom = dg[k] if k == n_lay else dg[k] + sp[k] * beta[k + 1]
            denom = torch.where(denom.abs() < 1e-30, 1e-30, denom)
            num = rh[k] - (sp[k] * alpha[k + 1] if k < n_lay else 0.0)
            alpha[k] = num / denom
            beta[k] = -sb[k] / denom
        den0 = dg[0] + sp[0] * beta[1]
        den0 = torch.where(den0.abs() < 1e-30, 1e-30, den0)
        Tsf_c = (rh[0] - sp[0] * alpha[1]) / den0

        # melting where the cold closure wants Tsf > 0; clamp to the
        # physical window (knife-edge columns with aicen ~ 1e-10 can walk
        # the unclamped solve below 0 K, where exp(-TTT/TsfK) overflows)
        melting = Tsf_c > 0.0
        Tsf = torch.clamp(torch.where(melting, cst.Tsmelt, Tsf_c),
                          -100.0, 0.0)
        x_prev = Tsf
        Tlay = []
        for k in range(1, n_lay + 1):
            x_prev = alpha[k] + beta[k] * x_prev
            Tlay.append(x_prev)
        Tsn = [torch.clamp(Tlay[k], -100.0, 0.0) for k in range(nslyr)]
        Tin = [clip(Tlay[nslyr + k], -100.0, Tm[k])
               for k in range(nilyr)]
        return Tsf, Tsn, Tin

    Tsn, Tin = Tsn0, Tin0
    for _ in range(nit):
        Tsf_n, Tsn_n, Tin_n = body(Tsf, Tsn, Tin)
        err = torch.stack(
            [(Tsf_n - Tsf).abs().max()]
            + [(a - b).abs().max() for a, b in zip(Tsn_n, Tsn)]
            + [(a - b).abs().max() for a, b in zip(Tin_n, Tin)]).max()
        Tsf, Tsn, Tin = Tsf_n, Tsn_n, Tin_n
        if not bool(err > TSF_ERRMAX):
            break

    fsurf, dfsurf, fsens, flat, flwout = surface_fluxes(
        Tsf, shcoef, lhcoef, potT, Qa, rhoa, flw, fswsfc)
    ki = conductivities(Tin)
    khs_sfc = 2.0 * cst.ksno / hslyr_p
    kh_sfc = torch.where(snow, khs_sfc, 2.0 * ki[0] / hilyr)
    Ttop = torch.where(snow, Tsn[0], Tin[0])
    fcondtop = kh_sfc * (Tsf - Ttop)
    fcondbot = 2.0 * ki[-1] / hilyr * (Tin[-1] - Tbot)

    qsno_new = [torch.where(snow, enthalpy_snow(t), q)
                for t, q in zip(Tsn, qsno)]
    if mushy:
        qice_new = [mush.enthalpy_mush(Tin[k], salin[k])
                    for k in range(nilyr)]
    else:
        qice_new = [enthalpy_ice(Tin[k], Tm[k]) for k in range(nilyr)]
    efinal = sum(q * hslyr for q in qsno_new) + \
        sum(q * hilyr for q in qice_new)

    return TempSolveOut(Tsf=Tsf, Tsno=Tsn, Tice=Tin, fsurf=fsurf,
                        fcondtop=fcondtop, fcondbot=fcondbot, fsens=fsens,
                        flat=flat, flwout=flwout, einit=einit,
                        efinal=efinal, keff_top=kh_sfc), qsno_new, qice_new


# ---------------------------------------------------------------------------
# growth / melt (BL99 thickness_changes)
# ---------------------------------------------------------------------------

class ThicknessOut(NamedTuple):
    hin: torch.Tensor
    hsn: torch.Tensor
    qice: list
    qsno: list
    meltt: torch.Tensor    # top ice melt (m)
    meltb: torch.Tensor    # bottom ice melt (m)
    melts: torch.Tensor    # snow melt (m)
    congel: torch.Tensor   # congelation growth (m)
    snoice: torch.Tensor   # snow-ice formation (m)
    evapn: torch.Tensor    # evaporative water flux (kg/m^2/s)
    evapsn: torch.Tensor   # snow portion of evapn (kg/m^2/s)
    fhocn: torch.Tensor    # heat flux to ocean (W/m^2)
    freshn: torch.Tensor   # fresh water flux to ocean (kg/m^2/s)
    fsaltn: torch.Tensor   # salt flux to ocean (kg/m^2/s)


def thickness_changes(dt, nilyr, nslyr, *, hin, hsn, qice, qsno, Tm, salin,
                      Tbot, fbot, fsurf, fcondtop, fcondbot, flat, sss,
                      qbot_new=None, saltflux_option="constant",
                      ice_ref_salinity=4.0):
    """Growth & melt from the flux imbalances (BL99 bookkeeping).

    fbot: ocean->ice heat flux at the bottom (W/m^2, negative = melting
    potential used); fsurf/fcondtop at the surface. Layer thicknesses are
    uniform before and after (adjust_enthalpy remaps at the end).
    Returns (ThicknessOut, dzi, dzs).
    """
    hilyr = hin / nilyr
    hslyr0 = hsn / nslyr

    dzi = [hilyr + torch.zeros_like(hin) for _ in range(nilyr)]
    dzs = [hslyr0 + torch.zeros_like(hsn) for _ in range(nslyr)]
    qi = list(qice)
    qs = list(qsno)

    meltt = torch.zeros_like(hin)
    meltb = torch.zeros_like(hin)
    melts = torch.zeros_like(hin)
    fhocn = torch.zeros_like(hin)

    ice_present = hin > cst.puny

    # --- sublimation / condensation at the top (latent heat flux) ---------
    # negative flat = sublimation (supply-limited mass loss), positive =
    # condensation deposited as frost on the top snow layer
    evap_pot = flat / cst.Lsub
    subl = -torch.clamp(evap_pot, max=0.0) * dt / cst.rhos
    dhs_subl = torch.minimum(subl * (cst.rhos / cst.rhos), sum_list(dzs))
    rem = (subl - dhs_subl) * cst.rhos / cst.rhoi
    dhi_subl = torch.minimum(rem, sum_list(dzi))
    dzs = shave_layers(dzs, dhs_subl, top=True)
    dzi = shave_layers(dzi, dhi_subl, top=True)
    dhs_frost = torch.where(
        ice_present, torch.clamp(evap_pot, min=0.0) * dt / cst.rhos, 0.0)
    dzs[0] = dzs[0] + dhs_frost
    evapn = (cst.rhos * (dhs_frost - dhs_subl) - cst.rhoi * dhi_subl) / dt
    evapsn = cst.rhos * (dhs_frost - dhs_subl) / dt

    # --- bottom growth / melt ---------------------------------------------
    # E_freeze = fbot - fcondbot (J/m^2, positive = freezing)
    ebot = (fbot - fcondbot) * dt
    grow = torch.clamp(ebot, min=0.0)
    Tm_bot = Tm[-1]
    if qbot_new is None:
        qbot = enthalpy_ice(torch.clamp(Tbot, min=Tm_bot - 5.0), Tm_bot)
    else:
        qbot = qbot_new
    dhi_grow = torch.where(ice_present,
                           grow / torch.clamp(-qbot, min=1.0), 0.0)
    congel = dhi_grow
    qi[-1] = safe_mix(qi[-1], dzi[-1], qbot, dhi_grow)
    dzi[-1] = dzi[-1] + dhi_grow

    # bottom melt: ebot<0 melts layers bottom-up using their enthalpy
    emelt = torch.clamp(-ebot, min=0.0)
    for k in range(nilyr - 1, -1, -1):
        cap = -qi[k] * dzi[k]
        frac = torch.clamp(emelt / torch.clamp(cap, min=cst.puny), 0.0, 1.0)
        dh = frac * dzi[k]
        meltb = meltb + dh
        dzi[k] = dzi[k] - dh
        emelt = torch.clamp(emelt - cap, min=0.0)
    fhocn = fhocn + emelt / dt

    # --- top melt ---------------------------------------------------------
    etop = torch.clamp(fsurf - fcondtop, min=0.0) * dt
    for k in range(nslyr):
        cap = -qs[k] * dzs[k]
        frac = torch.clamp(etop / torch.clamp(cap, min=cst.puny), 0.0, 1.0)
        dh = frac * dzs[k]
        melts = melts + dh
        dzs[k] = dzs[k] - dh
        etop = torch.clamp(etop - cap, min=0.0)
    for k in range(nilyr):
        cap = -qi[k] * dzi[k]
        frac = torch.clamp(etop / torch.clamp(cap, min=cst.puny), 0.0, 1.0)
        dh = frac * dzi[k]
        meltt = meltt + dh
        dzi[k] = dzi[k] - dh
        etop = torch.clamp(etop - cap, min=0.0)
    fhocn = fhocn + etop / dt

    # --- snow-ice formation -----------------------------------------------
    hi_new = sum_list(dzi)
    hs_new = sum_list(dzs)
    dhsn = (cst.rhoi * hi_new + cst.rhos * hs_new - cst.rhow * hi_new) / \
        (cst.rhos + cst.rhow - cst.rhoi)
    dhsn = clip(dhsn, 0.0, hs_new)
    dhin = dhsn * cst.rhos / cst.rhoi
    snoice = torch.where(ice_present, dhin, 0.0)
    qs_top = qs[0]
    dzs = shave_layers(dzs, dhsn, top=True)
    qi[0] = safe_mix(qi[0], dzi[0], qs_top * cst.rhoi / cst.rhos, snoice)
    dzi[0] = dzi[0] + snoice

    hi_new = sum_list(dzi)
    hs_new = sum_list(dzs)

    # --- fresh & salt fluxes: exact total-mass-change form ------------------
    dhi_total = meltt + meltb
    freshn = (cst.rhoi * (hin - hi_new) + cst.rhos * (hsn - hs_new)) / dt \
        + evapn
    if saltflux_option == "prognostic":
        S_melt = sum_list(list(salin)) / len(salin)
        S_grow = salin[-1]
    else:
        S_melt = S_grow = ice_ref_salinity
    fsaltn = cst.rhoi * 1e-3 / dt * (S_melt * dhi_total - S_grow * congel)

    return ThicknessOut(hin=hi_new, hsn=hs_new, qice=qi, qsno=qs,
                        meltt=meltt, meltb=meltb, melts=melts, congel=congel,
                        snoice=snoice, evapn=evapn, evapsn=evapsn,
                        fhocn=fhocn, freshn=freshn, fsaltn=fsaltn), dzi, dzs


def sum_list(xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def safe_mix(q_old, h_old, q_add, h_add):
    den = h_old + h_add
    return torch.where(
        den > cst.puny,
        (q_old * h_old + q_add * h_add) / torch.clamp(den, min=cst.puny),
        q_old)


def shave_layers(dz, amount, top=True):
    """Remove `amount` of total thickness from the top (or bottom) of the
    layer stack, sequentially."""
    out = list(dz)
    rem = amount
    order = range(len(dz)) if top else range(len(dz) - 1, -1, -1)
    for k in order:
        dh = torch.minimum(rem, out[k])
        out[k] = out[k] - dh
        rem = rem - dh
    return out


def adjust_enthalpy(dz, q, nlyr, h_total):
    """Conservatively remap layer enthalpies back to equal-thickness layers
    (piecewise-constant reconstruction)."""
    zold = [torch.zeros_like(h_total)]
    for k in range(nlyr):
        zold.append(zold[-1] + dz[k])
    hl = h_total / nlyr
    hl_p = torch.clamp(hl, min=cst.puny)
    qnew = []
    for k in range(nlyr):
        zt = hl * k
        zb = hl * (k + 1)
        acc = torch.zeros_like(h_total)
        for m in range(nlyr):
            ov = torch.clamp(
                torch.minimum(zb, zold[m + 1]) - torch.maximum(zt, zold[m]),
                min=0.0)
            acc = acc + q[m] * ov
        qnew.append(torch.where(hl > cst.puny, acc / hl_p, 0.0))
    return qnew
