"""Mechanical redistribution: ridging, rafting, opening; Rothrock strength
(PyTorch port of cice_tpu/columns/ridging.py).

Thorndike et al. (1975) redistribution theory, Hibler (1980) ridging,
Lipscomb et al. (2007) exponential participation/redistribution
(krdg_partic=1 / krdg_redist=1), Rothrock (1975) energetics strength
(kstrength=1), Hibler (1979) strength (kstrength=0). Dense over
(ncat, ny, nx).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as cst
from ..ops import lsum
from ..core.reductions import host_read
from .itd import (cleanup_itd, dep_index, name_offsets, pack_tracers, rebin,
                  unpack_tracers)

ASTAR = 0.05          # e-folding of the exponential participation function
MAXRAFT = 1.0         # max thickness of rafting ice (m)
CS = 0.25             # fraction of shear energy contributing to ridging
NITER_RDG = 3         # cap on ridging passes per step
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


def _exp_overlap(hrmin, hrexp, lo, hi_b):
    """Area & volume fractions of the exponential ridge-thickness pdf
    g(h) = exp(-(h-hrmin)/hrexp)/hrexp on [lo, hi_b] (receiver category)."""
    lam = torch.clamp(hrexp, min=cst.puny)
    a = torch.maximum(lo, hrmin)
    x1 = torch.clamp((a - hrmin) / lam, min=0.0)
    x2 = torch.clamp((hi_b - hrmin) / lam, min=0.0)
    x2 = torch.where(hi_b >= 1e8, 1e8, x2)   # top category extends to inf
    e1 = torch.exp(-x1)
    e2 = torch.where(x2 >= 1e8, 0.0, torch.exp(-x2))
    farea = e1 - e2
    # first moment: int h g = hrmin*farea + lam*((1+x1)e1-(1+x2)e2)
    fvol = hrmin * farea + lam * ((1.0 + x1) * e1 - (1.0 + x2) * e2)
    ok = hi_b > hrmin
    return torch.where(ok, farea, 0.0), torch.where(ok, fvol, 0.0)


@functools.lru_cache(maxsize=16)
def _ridge_tables(registry, hin_max, dtype, device):
    """Per (registry, bounds, dtype, device): the volume-dependent row mask
    (1, NT, 1, 1) and the receiver bin edges lo/hi (1, ncat, 1, 1)."""
    from ..model.state import DEP_VICE
    from .itd import flat_dep_table
    didx, _ = flat_dep_table(registry)
    maskv = torch.as_tensor((didx == DEP_VICE).astype(np.float32),
                            dtype=dtype, device=device)[None, :, None, None]
    bounds = np.array([float(b) for b in hin_max])
    bounds[-1] = 1e9
    lo = torch.as_tensor(bounds[:-1], dtype=dtype,
                         device=device)[None, :, None, None]
    hi_b = torch.as_tensor(bounds[1:], dtype=dtype,
                           device=device)[None, :, None, None]
    return maskv, lo, hi_b


def ridge_ice(cfg, aicen, vicen, vsnon, trcrn, *, divu, Delta, dt, hin_max,
              registry, mesh=None):
    """One ridging step. Closing rate from dynamics:
    rdg_conv = -min(divu,0), rdg_shear = Cs*(Delta - |divu|)/2. Passes
    repeat (at least one, at most NITER_RDG) while some cell still has
    closing left, read on the host once per pass. Returns the updated state
    and a dict of diagnostics (dardg1dt, dardg2dt, dvirdgdt, opening, the
    cleanup fluxes, the per-category rates and `npass`, the passes taken).
    """
    d = cfg.dynamics
    dev = aicen.device

    closing_net = CS * 0.5 * (Delta - divu.abs()) - torch.clamp(divu, max=0.0)
    closing_net = torch.clamp(closing_net, min=0.0)     # 1/s
    opning = torch.clamp(divu, min=0.0) + (
        closing_net + torch.clamp(divu, max=0.0)
        - torch.clamp(divu, min=0.0)) * 0.0
    dardg1 = torch.zeros_like(divu)
    dardg2 = torch.zeros_like(divu)
    dvirdg = torch.zeros_like(divu)
    dardg1n = torch.zeros_like(aicen)
    dardg2n = torch.zeros_like(aicen)
    dvirdgn = torch.zeros_like(aicen)
    araftn = torch.zeros_like(aicen)     # receiver-side rafted area gains
    vraftn = torch.zeros_like(aicen)
    dpnd_ridge = torch.zeros_like(divu)  # pond water on ridging donor area
    aparticn = torch.zeros_like(aicen)
    krdgn = torch.zeros_like(aicen)

    didx = dep_index(registry, dev)
    maskv, lo, hi_b = _ridge_tables(registry, tuple(float(h) for h in hin_max),
                                    aicen.dtype, dev)
    off = name_offsets(registry)
    trp = pack_tracers(trcrn, registry)       # (ncat, NT, ny, nx)
    have_pond = "apnd" in off and "hpnd" in off

    closing_rem = closing_net * dt         # total fractional area to close
    npass = 0
    while npass < 1 or (npass < NITER_RDG
                        and host_read("ridge", closing_rem.max() > 1e-9,
                                      mesh)):
        aice = lsum(aicen, dim=0)
        aice0 = torch.clamp(1.0 - aice, 0.0, 1.0)
        rp = ridge_prep(aicen, vicen, aice0, d.mu_rdg)
        if npass == 0:                  # diagnostics snapshot, first pass
            aparticn = rp.apartic[1:]
            krdgn = rp.krdg
        # area closed this pass (cannot exceed what participation provides)
        clos = torch.clamp(closing_rem, max=0.9)
        scale = clos / rp.aksum
        # limit: do not remove more area than each donor has
        ow_take = rp.apartic[0] * scale
        lim = torch.where(ow_take > cst.puny,
                          aice0 / torch.clamp(ow_take, min=cst.puny), 1.0)
        take = rp.apartic[1:] * scale[None]
        lim = torch.minimum(lim, torch.amin(
            torch.where(take > cst.puny,
                        aicen / torch.clamp(take, min=cst.puny), 1.0), dim=0))
        lim = torch.clamp(lim, 0.0, 1.0)
        scale = scale * lim

        # donor -> receiver transfers (n donor, m receiver): all removals
        # use the pass-start state, and receivers merge tracers by total
        # weighted mean
        ardg = rp.apartic[1:] * scale[None]           # (ncat, ny, nx)
        have = aicen > cst.puny
        aicen_p = torch.clamp(aicen, min=cst.puny)
        ardg = torch.where(have, torch.minimum(ardg, aicen), 0.0)
        frac = torch.where(have, ardg / aicen_p, 0.0)
        vrdg = vicen * frac                   # donor volume (conserved)
        srdg = vsnon * frac                   # snow rides with the ridge
        area_r = ardg / rp.krdg               # new ridge area per donor

        # overlap of donor n's exponential ridge pdf with receiver m's bin
        fa, fv = _exp_overlap(rp.hrmin[:, None], rp.hrexp[:, None], lo, hi_b)
        fa_n = fa / torch.clamp(lsum(fa, 1, keepdim=True), min=cst.puny)
        fv_n = fv / torch.clamp(lsum(fv, 1, keepdim=True), min=cst.puny)
        da = area_r[:, None] * fa_n           # (n, m, ny, nx)
        dv = vrdg[:, None] * fv_n
        ds = srdg[:, None] * fa_n

        a_rm = aicen - ardg                   # post-removal donor state
        v_rm = vicen - vrdg
        s_rm = vsnon - srdg
        da_r = lsum(da)                  # per-receiver gains (m,ny,nx)
        dv_r = lsum(dv)
        ds_r = lsum(ds)

        # packed merge: u[n,T] = t[n,T] * (dep-selected donor pool amount);
        # the receiver's contribution is u contracted over donors with the
        # dep group's receiver distribution (fa for area/snow rows, fv for
        # volume rows), one donor at a time to bound the temporary
        wsel = torch.stack([area_r, vrdg, srdg])[didx].transpose(0, 1)
        u = trp * wsel                        # (n, NT, ny, nx)
        u_v = u * maskv
        u_a = u - u_v
        contrib = None
        for n in range(aicen.shape[0]):
            c = u_a[n][None] * fa_n[n][:, None] \
                + u_v[n][None] * fv_n[n][:, None]
            contrib = c if contrib is None else contrib + c
        wr = torch.stack([a_rm, v_rm, s_rm])[didx].transpose(0, 1)
        wd_r = torch.stack([da_r, dv_r, ds_r])[didx].transpose(0, 1)
        den = wr + wd_r
        trp_new = torch.where(
            den > cst.puny,
            (trp * wr + contrib) / torch.clamp(den, min=cst.puny), trp)

        dardg1 = dardg1 + lsum(ardg)
        dvirdg = dvirdg + lsum(vrdg)
        dardg2 = dardg2 + lsum(area_r)
        dardg1n = dardg1n + ardg
        dardg2n = dardg2n + da_r
        dvirdgn = dvirdgn + dv_r
        # rafting split: thin donors (hi < MAXRAFT) are in the hrmin=2*hi
        # doubling regime; their receiver-side gains count as rafted ice
        hi_d = torch.where(have, vicen / aicen_p, 0.0)
        raft_d = (hi_d < MAXRAFT)[:, None]
        araftn = araftn + lsum(torch.where(raft_d, da, 0.0))
        vraftn = vraftn + lsum(torch.where(raft_d, dv, 0.0))
        # pond water riding on ridged donor area drains to the ocean
        if have_pond:
            apnd_d = trp[:, off["apnd"][0]]
            hpnd_d = trp[:, off["hpnd"][0]]
            dpnd_ridge = dpnd_ridge + lsum(
                ardg * torch.clamp(apnd_d, 0.0, 1.0)
                * torch.clamp(hpnd_d, min=0.0), dim=0)

        aicen = a_rm + da_r
        vicen = v_rm + dv_r
        vsnon = s_rm + ds_r
        trp = trp_new
        closing_rem = torch.clamp(closing_rem - clos * lim, min=0.0)
        npass += 1

    aicen, vicen, vsnon, trp = rebin(aicen, vicen, vsnon, trp, hin_max,
                                     registry, mesh)
    aicen, vicen, vsnon, trp, fclean = cleanup_itd(aicen, vicen, vsnon,
                                                   trp, registry, dt=dt)
    trcrn = unpack_tracers(trp, registry)

    diags = dict(dardg1dt=dardg1 / dt, dardg2dt=dardg2 / dt,
                 dvirdgdt=dvirdg / dt, opening=opning,
                 fresh_cleanup=fclean["fresh"], fsalt_cleanup=fclean["fsalt"],
                 fhocn_cleanup=fclean["fhocn"],
                 dardg1ndt=dardg1n / dt, dardg2ndt=dardg2n / dt,
                 dvirdgndt=dvirdgn / dt, aparticn=aparticn, krdgn=krdgn,
                 aredistn=dardg2n, vredistn=dvirdgn,
                 araftn=araftn, vraftn=vraftn, dpnd_ridge=dpnd_ridge,
                 npass=npass)
    return aicen, vicen, vsnon, trcrn, diags
