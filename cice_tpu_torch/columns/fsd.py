"""Floe size distribution (tr_fsd): thermodynamic evolution and wave
fracture (PyTorch port of cice_tpu/columns/fsd.py; Roach, Horvat, Dean &
Bitz 2018 joint floe-size/thickness distribution, Horvat & Tziperman 2015
wave fracture).

Tracer: fsd (ncat, nfsd, ny, nx), the area fraction of each category's ice
in each floe-size bin; it sums to 1 over bins where ice is present. The
bins are kept as a list of (ncat, ny, nx) planes while they are updated,
so each plane takes the JAX package's additions in its order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as cst
from ..ops import clip

# 12-bin floe radius boundaries (m) of Roach et al. (2018) (nfsd=12); other
# nfsd values take the first nfsd+1 bounds or a power-law extension
FLOE_RAD_BOUNDS = np.array(
    [0.0665, 5.31, 14.2, 29.0, 52.7, 87.8, 139.5, 211.8,
     308.4, 431.6, 585.8, 774.8, 1002.0])


def fsd_bounds(nfsd: int):
    """(lower, upper, mid) floe radii (m) for nfsd bins."""
    if nfsd + 1 <= len(FLOE_RAD_BOUNDS):
        b = FLOE_RAD_BOUNDS[:nfsd + 1]
    else:
        extra = FLOE_RAD_BOUNDS[-1] * (1.3 ** np.arange(
            1, nfsd + 2 - len(FLOE_RAD_BOUNDS)))
        b = np.concatenate([FLOE_RAD_BOUNDS, extra])
    return b[:-1], b[1:], 0.5 * (b[:-1] + b[1:])


def _first_bin(fsd):
    """All area in the smallest floe bin, shaped like fsd."""
    base = torch.zeros_like(fsd)
    base[:, 0] = 1.0
    return base


def fsd_cleanup(fsd, aicen):
    """Renormalize the FSD to sum to 1 over bins wherever ice exists:
    negative clipping and normalization; ice-free cells get the
    all-small-floes distribution."""
    del aicen
    fsd = torch.clamp(fsd, min=0.0)
    tot = torch.sum(fsd, dim=1, keepdim=True)
    ok = tot > cst.puny
    return torch.where(ok, fsd / torch.clamp(tot, min=cst.puny),
                       _first_bin(fsd))


def fsd_new_ice(fsd, aicen, da_new, nfsd: int):
    """New ice forms as the smallest floes: re-weight the distribution by
    the old/new area split."""
    del nfsd
    a_old = torch.clamp(aicen, min=0.0)
    a_new = torch.clamp(da_new, min=0.0)
    tot = a_old + a_new
    w_old = torch.where(tot > cst.puny,
                        a_old / torch.clamp(tot, min=cst.puny), 1.0)
    return fsd * w_old[:, None] + _first_bin(fsd) * (1.0 - w_old[:, None])


def fsd_lateral_growth(cfg, dt, fsd, G_rad, nfsd: int):
    """Lateral growth/melt advects area in floe-size space, df/dt =
    -d(G f)/dr, with growth speed G_rad (m/s, >0 growth): first-order
    upwind over the static bins."""
    del cfg
    lo, hi, _ = fsd_bounds(nfsd)
    widths = [float(w) for w in (hi - lo)]
    grow = G_rad > 0.0
    aG = torch.abs(G_rad)
    res = []
    for n in range(nfsd):
        c_out = torch.clamp(aG * dt / widths[n], 0.0, 1.0)
        res.append(fsd[:, n] * (1.0 - c_out))
    for n in range(nfsd):
        c_in_src = torch.clamp(aG * dt / widths[n], 0.0, 1.0)
        inflow = fsd[:, n] * c_in_src
        # growth: into bin n+1 (the largest bin keeps its area); melt: n-1
        up, dn = min(n + 1, nfsd - 1), max(n - 1, 0)
        res[up] = res[up] + torch.where(grow, inflow, 0.0)
        res[dn] = res[dn] + torch.where(grow, 0.0, inflow)
    return torch.stack(res, dim=1)


def fsd_weld(dt, fsd, aicen, frzmlt, nfsd: int):
    """Floe welding under freezing: quadratic coagulation moving area up
    one bin at the rate KWELD * aice * f^2."""
    KWELD = 0.01 / cst.secday      # merge rate scale (1/s)
    freezing = (frzmlt > 0.0).to(fsd.dtype)
    res = [fsd[:, n] for n in range(nfsd)]
    for n in range(nfsd - 1):
        f = fsd[:, n]
        dfn = clip(KWELD * dt * aicen * f ** 2, 0.0, f)
        dfn = dfn * freezing[None]
        res[n] = res[n] + (-dfn)
        res[n + 1] = res[n + 1] + dfn
    return torch.stack(res, dim=1)


# --- spectral fracture ------------------------------------------------------

EPS_CRIT = 3.0e-5        # critical flexural strain (Horvat & Tziperman 2015)
NX_TRANSECT = 200        # surface-realization sample points
DX_TRANSECT = 25.0       # sample spacing (m)
_G = 9.80616


def wave_frac_histogram(E, dwavefreq, wavefreq, hbar, nfsd: int):
    """Fracture-length histogram from a deterministic sea-surface
    realization:

      eta(x)   = sum_k sqrt(2 E_k df_k) cos(2 pi x / lam_k + phi_k)
      strain   = (hbar/2) |d2 eta/dx2|

    Fractures sit at local strain maxima above EPS_CRIT; the new floe sizes
    are the gaps between successive fracture points, binned to the FSD
    categories (length-weighted, so the redistribution conserves area).
    The phases follow the golden-angle sequence. The strain field is
    (NX_TRANSECT, ny, nx): 98 MB at gx1 in float32.
    Returns W: (nfsd, ny, nx)."""
    dtype, dev = E.dtype, E.device
    nfreq = E.shape[0]
    lam = _G / (2.0 * math.pi * wavefreq ** 2)             # deep water (m)
    amp = torch.sqrt(2.0 * torch.clamp(E, min=0.0) *
                     dwavefreq[:, None, None])
    phi = (2.0 * math.pi * 0.6180339887) * torch.arange(
        nfreq, dtype=dtype, device=dev)
    x = torch.arange(NX_TRANSECT, dtype=dtype, device=dev) * DX_TRANSECT
    karg = (2.0 * math.pi / lam)[:, None] * x[None, :] + phi[:, None]
    curv = -(2.0 * math.pi / lam[:, None]) ** 2 * torch.cos(karg)
    strain = 0.5 * hbar[None] * torch.abs(
        torch.einsum("kt,kij->tij", curv, amp))            # (nx_t, ny, nx)
    edge = torch.zeros_like(strain[:1])
    s_prev = torch.cat([edge, strain[:-1]])
    s_next = torch.cat([strain[1:], edge])
    mark = (strain > EPS_CRIT) & (strain > s_prev) & (strain >= s_next)
    del s_prev, s_next
    idx = torch.arange(NX_TRANSECT, dtype=dtype, device=dev)[:, None, None]
    marked_idx = torch.where(mark, idx, -1.0)
    prev_incl = torch.cummax(marked_idx, dim=0).values
    prev_excl = torch.cat([torch.full_like(prev_incl[:1], -1.0),
                           prev_incl[:-1]])
    gap = torch.where(mark & (prev_excl >= 0.0),
                      (idx - prev_excl) * DX_TRANSECT, 0.0)
    del marked_idx, prev_incl, prev_excl, mark
    lo, hi_b, _ = fsd_bounds(nfsd)
    W = []
    for n in range(nfsd):
        inbin = (gap > float(lo[n])) & (gap <= float(hi_b[n]))
        W.append(torch.sum(torch.where(inbin, gap, 0.0), dim=0))
    return torch.stack(W)                                  # (nfsd, ny, nx)


def fsd_wave_fracture(cfg, dt, fsd, aicen, vicen, hs_wave, Tp_wave,
                      nfsd: int, wave_spectrum=None):
    """Wave-induced floe fracture. With a 25-bin `wave_spectrum` the
    fracture sizes come from the surface-realization histogram and the
    fractured area lands on the histogram bins smaller than the donor
    floe. Without one, the dominant-wavelength scheme applies (floes above
    lambda/4 break; the area lands on the bins below the critical size,
    weighted by bin width). Strain criterion in both: flexural strain
    > EPS_CRIT."""
    del cfg
    frac_rate = min(max(dt / (6.0 * 3600.0), 0.0), 1.0)
    res = [fsd[:, n] for n in range(nfsd)]
    if wave_spectrum is not None:
        from ..model.forcing import wave_frequencies
        # flexural plate thickness = the ice thickness vice/aice
        hbar = torch.sum(vicen, dim=0) / \
            torch.clamp(torch.sum(aicen, dim=0), min=cst.puny)
        f, df = wave_frequencies(fsd.dtype, fsd.device)
        W = wave_frac_histogram(wave_spectrum, df, f, hbar, nfsd)
        active = hs_wave > 0.01
        # donor bins lose area where fracture pieces smaller than the floe
        # exist; the gains land on the histogram bins (k < i)
        for i in range(1, nfsd):
            wsum = sum(W[k] for k in range(i))
            lose = active & (wsum > 0.0)
            df_i = torch.where(lose[None], fsd[:, i] * frac_rate, 0.0)
            res[i] = res[i] + (-df_i)
            wsum_p = torch.clamp(wsum, min=cst.puny)
            for k in range(i):
                share = torch.where(wsum > 0.0, W[k] / wsum_p, 0.0)
                res[k] = res[k] + df_i * share[None]
        return torch.stack(res, dim=1)
    lam = _G * torch.clamp(Tp_wave, min=1.0) ** 2 / (2.0 * math.pi)
    hi = torch.where(aicen > cst.puny,
                     vicen / torch.clamp(aicen, min=cst.puny), 0.0)
    eps = 2.0 * hi * math.pi ** 2 * torch.clamp(hs_wave, min=0.0)[None] / \
        torch.clamp(lam, min=1.0)[None] ** 2
    active = (eps > EPS_CRIT) & (hs_wave[None] > 0.01)
    r_crit = 0.5 * lam[None] / 2.0          # floes above lambda/4 break

    lo, hi_b, mid = fsd_bounds(nfsd)
    widths = [float(w) for w in (hi_b - lo)]
    mid = [float(x) for x in mid]
    hi_b = [float(x) for x in hi_b]
    broken = torch.zeros_like(fsd[:, 0])
    for n in range(nfsd):
        breaks = active & (r_crit < mid[n])
        dfn = torch.where(breaks, fsd[:, n] * frac_rate, 0.0)
        res[n] = res[n] + (-dfn)
        broken = broken + dfn
    # deposit into the bins fully below r_crit, weighted by bin width
    wsum = torch.zeros_like(broken)
    wts = []
    for n in range(nfsd):
        w = torch.where(active & (hi_b[n] <= r_crit), widths[n],
                        torch.zeros_like(broken))
        wts.append(w)
        wsum = wsum + w
    wsum_p = torch.clamp(wsum, min=cst.puny)
    for n in range(nfsd):
        share = torch.where(wsum > 0, wts[n] / wsum_p, 0.0)
        res[n] = res[n] + broken * share
    # if no bin qualifies (waves break everything), the smallest takes it
    res[0] = res[0] + torch.where(wsum > 0, 0.0, broken)
    return torch.stack(res, dim=1)


def _fsd_agg(fsd, aicen):
    """Cell aggregate of the joint distribution: (nfsd, ny, nx) area per
    floe-size bin."""
    return torch.sum(fsd * aicen[:, None], dim=0)


def step_dyn_wave(cfg, dt, *, fsd, aicen, vicen, hs_wave, Tp_wave,
                  wave_spectrum=None, return_tend: bool = False):
    """Wave-fracture phase (reference step_dyn_wave, ice_step_mod.F90:897).
    Returns the updated (cleaned) fsd; with return_tend=True also
    {'dafsd_wave': the aggregate tendency, 1/s per bin}."""
    nfsd = cfg.domain.nfsd
    if not cfg.tracers.tr_fsd or nfsd <= 1:
        return (fsd, {}) if return_tend else fsd
    out = fsd_wave_fracture(cfg, dt, fsd, aicen, vicen, hs_wave, Tp_wave,
                            nfsd, wave_spectrum=wave_spectrum)
    out = fsd_cleanup(out, aicen)
    if return_tend:
        tend = {"dafsd_wave": (_fsd_agg(out, aicen) -
                               _fsd_agg(fsd, aicen)) / dt}
        return out, tend
    return out


def step_fsd_thermo(cfg, dt, *, fsd, aicen, da_new, G_rad, frzmlt,
                    return_tend: bool = False):
    """Thermodynamic FSD evolution: new ice, lateral growth/melt and
    welding. With return_tend=True also the per-process aggregate
    tendencies (1/s per bin; lateral growth and melt split by the sign of
    the growth rate)."""
    nfsd = cfg.domain.nfsd
    if not cfg.tracers.tr_fsd or nfsd <= 1:
        return (fsd, {}) if return_tend else fsd
    f1 = fsd_new_ice(fsd, aicen, da_new, nfsd)
    f2 = fsd_lateral_growth(cfg, dt, f1, G_rad, nfsd)
    f3 = fsd_weld(dt, f2, aicen, frzmlt, nfsd)
    out = fsd_cleanup(f3, aicen)
    if not return_tend:
        return out
    a0 = _fsd_agg(fsd, aicen)
    a1 = _fsd_agg(f1, aicen)
    a2 = _fsd_agg(f2, aicen)
    a3 = _fsd_agg(f3, aicen)
    dlat = (a2 - a1) / dt
    growing = torch.any(G_rad > 0.0, dim=0)       # cell-level growth flag
    tend = {
        "dafsd_newi": (a1 - a0) / dt,
        "dafsd_latg": torch.where(growing[None], dlat, 0.0),
        "dafsd_latm": torch.where(growing[None], 0.0, dlat),
        "dafsd_weld": (a3 - a2) / dt,
    }
    return out, tend
