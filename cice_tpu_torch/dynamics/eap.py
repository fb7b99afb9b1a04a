"""Elastic-anisotropic-plastic (EAP) rheology (PyTorch port of
cice_tpu/dynamics/eap.py; reference ice_dyn_eap.F90 `eap`:89, `init_eap`
yield-surface tables :557-724, `stress_eap`:1163, `update_stress_rdg`:1581,
`stepa`:1870, `calc_ffrac`:1978; Tsamados, Feltham & Wilchinsky 2013,
Appendix A).

A per-corner structure tensor (a11, a12; trace 1) evolves with the stress
state; the anisotropic stress comes from lookup tables sigma_r/sigma_s(x,
y, A1) built once with numpy by quadrature of the diamond-floe contact
kernels. The lookup picks the nearest lower entry (the reference's
interpolate_stress_rdg=.false.): a float ratio truncated to an integer, so
an input one ulp from a bin edge may pick the neighbouring entry. The
`ndte` subcycles are a Python loop sharing the B-grid stress divergence
and momentum step with the EVP solver. On a state sharded across ranks
they run as the wide-halo EVP runs (`parallel.evp_wide.eap_solve_wide`):
`_subcycle` on each rank's padded tile, several per halo exchange.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as cst
from ..core.grid import Grid
from .common import DynPrep, EvpParams, stepu_dense, strain_rates_B
from .evp import stress_divergence

NX_YIELD, NY_YIELD, NA_YIELD = 41, 41, 21
KFRICTION = 0.45
PHI = math.pi / 12.0          # diamond floe acute half-angle
KFRAC = 0.001                 # fracturing rate constant (calc_ffrac)
FFRAC_THRESHOLD = 0.3
KTH = 0.2 * 0.001             # structure-tensor isotropic recovery rate
INVSIN = 1.0 / math.sin(2 * np.pi / 12.0) / (1.0 + KFRICTION * KFRICTION)


def _w1(a):
    return (-223.87569446 + 2361.2198663 * a - 10606.56079975 * a ** 2
            + 26315.50025642 * a ** 3 - 38948.30444297 * a ** 4
            + 34397.72407466 * a ** 5 - 16789.98003081 * a ** 6
            + 3495.82839237 * a ** 7)


def _w2(a):
    return (-6670.68911883 + 70222.33061536 * a - 314871.71525448 * a ** 2
            + 779570.02793492 * a ** 3 - 1151098.82436864 * a ** 4
            + 1013896.59464498 * a ** 5 - 493379.44906738 * a ** 6
            + 102356.551518 * a ** 7)


def _contact_kernels(x, y, z, phi):
    """Ridging (r) and sliding (s) stress kernels for diamond floes at
    contact orientation z, strain direction x and A-alignment y
    (Tsamados et al. 2013 eq. A4-A8); numpy, broadcast over x, y, z."""
    pih = 0.5 * np.pi
    p = phi
    n1t2 = [np.cos(z + pih - p) * np.cos(z + p),
            np.cos(z + pih - p) * np.sin(z + p),
            np.sin(z + pih - p) * np.cos(z + p),
            np.sin(z + pih - p) * np.sin(z + p)]
    n2t1 = [np.cos(z - pih + p) * np.cos(z - p),
            np.cos(z - pih + p) * np.sin(z - p),
            np.sin(z - pih + p) * np.cos(z - p),
            np.sin(z - pih + p) * np.sin(z - p)]
    t1t2 = [np.cos(z - p) * np.cos(z + p),
            np.cos(z - p) * np.sin(z + p),
            np.sin(z - p) * np.cos(z + p),
            np.sin(z - p) * np.sin(z + p)]
    t2t1 = [np.cos(z + p) * np.cos(z - p),
            np.cos(z + p) * np.sin(z - p),
            np.sin(z + p) * np.cos(z - p),
            np.sin(z + p) * np.sin(z - p)]
    cy2 = np.cos(y) ** 2
    ty = np.tan(y)
    d11 = cy2 * (np.cos(x) + np.sin(x) * ty * ty)
    d12 = cy2 * ty * (-np.cos(x) + np.sin(x))
    d22 = cy2 * (np.sin(x) + np.cos(x) * ty * ty)

    def dot(t):
        return t[0] * d11 + (t[1] + t[2]) * d12 + t[3] * d22

    IIn1t2 = dot(n1t2)
    IIn2t1 = dot(n2t1)
    IIt1t2 = dot(t1t2)
    H12 = (-IIn1t2 >= cst.puny).astype(float)
    H21 = (-IIn2t1 >= cst.puny).astype(float)
    sgn = np.sign(IIt1t2 + cst.puny)

    s11r = -(H12 * n1t2[0] + H21 * n2t1[0])
    s12r = -0.5 * (H12 * (n1t2[1] + n1t2[2]) + H21 * (n2t1[1] + n2t1[2]))
    s22r = -(H12 * n1t2[3] + H21 * n2t1[3])
    s11s = sgn * (H12 * t1t2[0] + H21 * t2t1[0])
    s12s = sgn * 0.5 * (H12 * (t1t2[1] + t1t2[2]) + H21 * (t2t1[1] + t2t1[2]))
    s22s = sgn * (H12 * t1t2[3] + H21 * t2t1[3])
    return s11r, s12r, s22r, s11s, s12s, s22s


@functools.lru_cache(maxsize=1)
def yield_tables():
    """The 6 (NX, NY, NA) float32 lookup tables (s11r, s12r, s22r, s11s,
    s12s, s22s) by z-quadrature (init_eap, ice_dyn_eap.F90:649-718)."""
    nz = 100
    pi, piq, pih = np.pi, np.pi / 4, np.pi / 2
    da = 0.5 / (NA_YIELD - 1)
    dx = pi / (NX_YIELD - 1)
    dy = pi / (NY_YIELD - 1)
    dz = pi / nz
    xs = pi + piq - dx + dx * np.arange(1, NX_YIELD + 1)
    ys = -dy + dy * np.arange(1, NY_YIELD + 1)
    als = 0.5 - da + da * np.arange(1, NA_YIELD + 1)
    zs = -pih + dz * np.arange(1, nz + 1)

    k = _contact_kernels(xs[:, None, None], ys[None, :, None],
                         zs[None, None, :], PHI)        # each (nx, ny, nz)
    sin2phi = math.sin(2 * PHI)
    tables = []
    for comp in k:
        tab = np.zeros((NX_YIELD, NY_YIELD, NA_YIELD))
        for ia, a in enumerate(als[:-1]):
            w = _w1(a) * np.exp(-_w2(a) * zs * zs)
            tab[:, :, ia] = np.tensordot(comp, w, axes=([2], [0])) * dz / \
                sin2phi
        tables.append(tab)
    # the last entry: perfectly aligned (a delta distribution at z=0)
    k0 = _contact_kernels(xs[:, None], ys[None, :], np.zeros((1, 1)), PHI)
    for tab, comp0 in zip(tables, k0):
        tab[:, :, -1] = 0.5 * comp0 / sin2phi
    tables = [np.where(np.abs(t) < 1e-6, 0.0, t) for t in tables]
    return tuple(np.asarray(t, np.float32) for t in tables)


@functools.lru_cache(maxsize=4)
def _device_tables(device: torch.device):
    """The lookup tables flattened on `device` (float32, as built)."""
    return tuple(torch.as_tensor(t.reshape(-1), device=device)
                 for t in yield_tables())


def _principal_cos2(m11, m22, m12):
    """(Cos^2, Sin^2, CosSin) of the rotation to principal axes."""
    diff = m11 - m22
    denom = torch.sqrt(diff * diff + 4.0 * m12 * m12)
    ok = denom > cst.puny
    safe = torch.where(ok, denom, 1.0)
    c2 = torch.where(ok, 0.5 + 0.5 * diff / safe, 1.0)
    s2 = torch.where(ok, 0.5 - 0.5 * diff / safe, cst.puny)
    cs = torch.where(ok, m12 / safe, cst.puny)
    return c2, s2, cs


def stress_rdg(divu, tension, shear, a11, a12, strength, tabs):
    """The anisotropic yield stress targets at one corner from the lookup
    tables (update_stress_rdg): (stressp, stressm, stress12), all
    (ny, nx). `tabs` are the flattened float32 tables."""
    s11r, s12r, s22r, s11s, s12s, s22s = tabs
    a22 = 1.0 - a11
    Q11Q11, Q12Q12, Q11Q12 = _principal_cos2(a11, a22, a12)
    atemp = Q11Q11 * a11 + 2.0 * Q11Q12 * a12 + Q12Q12 * a22
    atemp = torch.maximum(atemp, 1.0 - atemp)

    d11 = 0.5 * (divu + tension)
    d12 = 0.5 * shear
    d22 = 0.5 * (divu - tension)
    Qd11Qd11, Qd12Qd12, Qd11Qd12 = _principal_cos2(d11, d22, d12)
    dtemp1 = Qd11Qd11 * d11 + 2.0 * Qd11Qd12 * d12 + Qd12Qd12 * d22
    dtemp2 = Qd12Qd12 * d11 - 2.0 * Qd11Qd12 * d12 + Qd11Qd11 * d22

    x = torch.atan2(dtemp2, torch.where(dtemp1 == 0, cst.puny, dtemp1))
    x = torch.where(x < np.pi / 4, x + 2 * np.pi, x)
    tany1 = Q11Q12 - Qd11Qd12
    tany2 = Q11Q11 - Qd12Qd12
    y = torch.atan2(tany1, torch.where(tany2 == 0, cst.puny, tany2))
    y = torch.where(y > np.pi, y - np.pi, y)
    y = torch.where(y < 0, y + np.pi, y)

    dx = np.pi / (NX_YIELD - 1)
    dy = np.pi / (NY_YIELD - 1)
    da = 0.5 / (NA_YIELD - 1)
    # truncation toward zero, as the reference package's astype(int32)
    kx = ((x - np.pi / 4 - np.pi) / dx).to(torch.int32).clamp(0, NX_YIELD - 1)
    ky = (y / dy).to(torch.int32).clamp(0, NY_YIELD - 1)
    ka = ((atemp - 0.5) / da).to(torch.int32).clamp(0, NA_YIELD - 1)
    flat = ((kx * NY_YIELD + ky) * NA_YIELD + ka).long()

    t11r, t12r, t22r = s11r[flat], s12r[flat], s22r[flat]
    t11s, t12s, t22s = s11s[flat], s12s[flat], s22s[flat]
    # the table sums stay float32, as in the reference package
    stressp = strength * (t11r + KFRICTION * t11s +
                          t22r + KFRICTION * t22s) * INVSIN
    stress12 = strength * (t12r + KFRICTION * t12s) * INVSIN
    stressm = strength * (t11r + KFRICTION * t11s -
                          t22r - KFRICTION * t22s) * INVSIN

    # back-rotation into general coordinates
    sig11 = 0.5 * (stressp + stressm)
    sig12 = stress12
    sig22 = 0.5 * (stressp - stressm)
    g11 = Q11Q11 * sig11 + Q12Q12 * sig22 - 2.0 * Q11Q12 * sig12
    g12 = Q11Q12 * sig11 - Q11Q12 * sig22 + (Q11Q11 - Q12Q12) * sig12
    g22 = Q12Q12 * sig11 + Q11Q11 * sig22 + 2.0 * Q11Q12 * sig12
    return g11 + g22, g11 - g22, g12


def calc_ffrac(stressp, stressm, stress12, a11, a12):
    """Structure-tensor source from the stress state (calc_ffrac:1978):
    diffusion toward the fracture-favoured orientation under unconfined
    compression or shear faulting."""
    sigma11 = 0.5 * (stressp + stressm)
    sigma12 = stress12
    sigma22 = 0.5 * (stressp - stressm)
    gamma = torch.where(stressm == 0.0, 0.5 * (np.pi / 2),
                        0.5 * torch.atan2(2.0 * sigma12,
                                          torch.where(stressm == 0, 1.0,
                                                      sigma11 - sigma22)))
    Q11 = torch.cos(gamma)
    Q12 = torch.sin(gamma)
    s1 = Q11 * Q11 * sigma11 + 2 * Q11 * Q12 * sigma12 + Q12 * Q12 * sigma22
    s2 = Q12 * Q12 * sigma11 - 2 * Q11 * Q12 * sigma12 + Q11 * Q11 * sigma22

    frac_active = ((s1 >= 0) & (s2 < 0)) | \
        ((s1 <= 0) & (s2 != 0) & (s1 / torch.where(s2 == 0, 1.0, s2)
                                  <= FFRAC_THRESHOLD) & (s2 < 0))
    m1 = torch.where(frac_active, KFRAC * (a11 - Q12 * Q12), 0.0)
    m2 = torch.where(frac_active, KFRAC * (a12 + Q11 * Q12), 0.0)
    return m1, m2


def _corners(sr):
    return ((sr.divune, sr.tensionne, sr.shearne),
            (sr.divunw, sr.tensionnw, sr.shearnw),
            (sr.divusw, sr.tensionsw, sr.shearsw),
            (sr.divuse, sr.tensionse, sr.shearse))


class EapState(NamedTuple):
    uvel: torch.Tensor
    vvel: torch.Tensor
    stressp: torch.Tensor     # (4, ny, nx)
    stressm: torch.Tensor
    stress12: torch.Tensor
    a11: torch.Tensor         # (4, ny, nx) per-corner structure tensor
    a12: torch.Tensor


def _subcycle(grid: Grid, p: EvpParams, prep: DynPrep, strength, tabs,
              uocn, vocn, st: EapState) -> EapState:
    sr = strain_rates_B(grid, st.uvel, st.vvel, p)
    m = prep.iceTmask
    sp, sm, s12, a11, a12 = [], [], [], [], []
    for c, (dv, tn, sh) in enumerate(_corners(sr)):
        tp, tm, t12 = stress_rdg(dv, tn, sh, st.a11[c], st.a12[c], strength,
                                 tabs)
        spc = torch.where(m, (st.stressp[c] + tp * p.arlx1i) * p.denom1,
                          st.stressp[c])
        smc = torch.where(m, (st.stressm[c] + tm * p.arlx1i) * p.denom1,
                          st.stressm[c])
        s12c = torch.where(m, (st.stress12[c] + t12 * p.arlx1i) * p.denom1,
                           st.stress12[c])
        sp.append(spc)
        sm.append(smc)
        s12.append(s12c)
        m1, m2 = calc_ffrac(spc, smc, s12c, st.a11[c], st.a12[c])
        # implicit relaxation toward isotropy (stepa)
        a11.append((st.a11[c] + 0.5 * KTH - m1) / (1.0 + KTH))
        a12.append((st.a12[c] - m2) / (1.0 + KTH))
    strintx, strinty = stress_divergence(grid, *sp, *sm, *s12)
    unew, vnew, _, _ = stepu_dense(st.uvel, st.vvel, strintx, strinty, prep,
                                   p, uocn, vocn)
    return EapState(unew, vnew, torch.stack(sp), torch.stack(sm),
                    torch.stack(s12), torch.stack(a11), torch.stack(a12))


def eap_solve(grid: Grid, p: EvpParams, prep: DynPrep, strength,
              stressp, stressm, stress12, *, uocn, vocn, a11, a12):
    """The EAP subcycle loop (reference `eap`:89). Returns (uvel, vvel,
    stressp, stressm, stress12, strintx, strinty, taubx, tauby, a11, a12,
    yieldstress): as evp_solve, with the structure tensor and the
    yield-surface stress diagnostic (a dict of yieldstress11/12/22)."""
    tabs = _device_tables(stressp.device)
    m3 = prep.iceTmask[None]
    st = EapState(prep.uvel, prep.vvel, torch.where(m3, stressp, 0.0),
                  torch.where(m3, stressm, 0.0),
                  torch.where(m3, stress12, 0.0), a11, a12)
    for _ in range(p.ndte):
        st = _subcycle(grid, p, prep, strength, tabs, uocn, vocn, st)
    return eap_finish(grid, p, prep, strength, tabs, st)


def eap_finish(grid: Grid, p: EvpParams, prep: DynPrep, strength, tabs,
               st: EapState):
    """The outputs of `eap_solve` from the state after its subcycles: the
    force diagnostics and the yield-surface stress at that state."""
    strintx, strinty = stress_divergence(grid, *st.stressp, *st.stressm,
                                         *st.stress12)
    Cb = prep.TbU / (torch.sqrt(st.uvel ** 2 + st.vvel ** 2) + cst.u0)

    # yield-surface stress diagnostic: the corner-averaged anisotropic
    # targets at the converged state (ice_dyn_eap.F90:1436-1446)
    sr = strain_rates_B(grid, st.uvel, st.vvel, p)
    tp_sum = tm_sum = t12_sum = 0.0
    for c, (dv, tn, sh) in enumerate(_corners(sr)):
        tp, tm, t12 = stress_rdg(dv, tn, sh, st.a11[c], st.a12[c], strength,
                                 tabs)
        tp_sum = tp_sum + tp
        tm_sum = tm_sum + tm
        t12_sum = t12_sum + t12
    msk = prep.iceTmask
    yieldstress = {
        "yieldstress11": torch.where(msk, 0.125 * (tp_sum + tm_sum), 0.0),
        "yieldstress22": torch.where(msk, 0.125 * (tp_sum - tm_sum), 0.0),
        "yieldstress12": torch.where(msk, 0.25 * t12_sum, 0.0),
    }
    return (st.uvel, st.vvel, st.stressp, st.stressm, st.stress12, strintx,
            strinty, -st.uvel * Cb, -st.vvel * Cb, st.a11, st.a12,
            yieldstress)
