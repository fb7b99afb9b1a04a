"""B-grid elastic-viscous-plastic (EVP) dynamics solver (PyTorch port of
cice_tpu/dynamics/evp.py; reference ice_dyn_evp.F90 `evp`:259,
`stress`:1457, Hunke & Dukowicz 2002 bilinear stresses).

`evp_solve` is the plain PyTorch version of the fused CUDA EVP kernel
(kernels/evp.py): the `ndte` subcycle loop is a Python loop of dense
tensor ops.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as cst
from ..constants import FIELD_LOC_CENTER, FIELD_TYPE_SCALAR
from ..core.grid import Grid
from ..core.halo import shift
from .common import DynPrep, EvpParams, stepu_dense, strain_rates_B, \
    visc_replpress

# bilinear basis-integral coefficients (reference ice_constants.F90:79-85)
P5, P25 = 0.5, 0.25
P333 = 1.0 / 3.0
P166 = 1.0 / 6.0
P222 = 2.0 / 9.0
P111 = 1.0 / 9.0
P055 = 1.0 / 18.0
P027 = 1.0 / 36.0


class EvpState(NamedTuple):
    """Carry of the subcycle loop."""
    uvel: torch.Tensor
    vvel: torch.Tensor
    stressp: torch.Tensor   # (4, ny, nx): NE, NW, SW, SE corner s11+s22
    stressm: torch.Tensor   # s11-s22
    stress12: torch.Tensor  # s12


def stress_update(grid: Grid, p: EvpParams, strength, DminTarea,
                  uvel, vvel, stressp, stressm, stress12, iceTmask):
    """One elastic stress relaxation step + stress-divergence force.

    Returns updated (stressp, stressm, stress12), each (4, ny, nx) in
    corner order [NE, NW, SW, SE], and (strintx, strinty) at U points."""
    sr = strain_rates_B(grid, uvel, vvel, p)

    zne, ene, rne = visc_replpress(strength, DminTarea, sr.Deltane, p)
    znw, enw, rnw = visc_replpress(strength, DminTarea, sr.Deltanw, p)
    zsw, esw, rsw = visc_replpress(strength, DminTarea, sr.Deltasw, p)
    zse, ese, rse = visc_replpress(strength, DminTarea, sr.Deltase, p)

    c1m = 1.0 - p.arlx1i * p.revp
    a1, d1 = p.arlx1i, p.denom1

    def relax(old, target):
        return torch.where(iceTmask, (old * c1m + a1 * target) * d1, old)

    sp1 = relax(stressp[0], zne * sr.divune - rne)
    sp2 = relax(stressp[1], znw * sr.divunw - rnw)
    sp3 = relax(stressp[2], zsw * sr.divusw - rsw)
    sp4 = relax(stressp[3], zse * sr.divuse - rse)

    sm1 = relax(stressm[0], ene * sr.tensionne)
    sm2 = relax(stressm[1], enw * sr.tensionnw)
    sm3 = relax(stressm[2], esw * sr.tensionsw)
    sm4 = relax(stressm[3], ese * sr.tensionse)

    s121 = relax(stress12[0], P5 * ene * sr.shearne)
    s122 = relax(stress12[1], P5 * enw * sr.shearnw)
    s123 = relax(stress12[2], P5 * esw * sr.shearsw)
    s124 = relax(stress12[3], P5 * ese * sr.shearse)

    strintx, strinty = stress_divergence(
        grid, sp1, sp2, sp3, sp4, sm1, sm2, sm3, sm4, s121, s122, s123, s124)

    return (torch.stack([sp1, sp2, sp3, sp4]),
            torch.stack([sm1, sm2, sm3, sm4]),
            torch.stack([s121, s122, s123, s124]),
            strintx, strinty)


def stress_terms(grid: Grid, sp1, sp2, sp3, sp4, sm1, sm2, sm3, sm4,
                 s121, s122, s123, s124):
    """The 8 per-T-cell contributions str1..str8 to the stress divergence
    at its 4 corners (reference `stress` str(:,:,1:8) assembly,
    ice_dyn_evp.F90:1647-1745)."""
    dxT, dyT, dxhy, dyhx = grid.dxT, grid.dyT, grid.dxhy, grid.dyhx

    ssigpn = sp1 + sp2
    ssigps = sp3 + sp4
    ssigpe = sp1 + sp4
    ssigpw = sp2 + sp3
    ssigp1 = (sp1 + sp3) * P055
    ssigp2 = (sp2 + sp4) * P055

    ssigmn = sm1 + sm2
    ssigms = sm3 + sm4
    ssigme = sm1 + sm4
    ssigmw = sm2 + sm3
    ssigm1 = (sm1 + sm3) * P055
    ssigm2 = (sm2 + sm4) * P055

    ssig12n = s121 + s122
    ssig12s = s123 + s124
    ssig12e = s121 + s124
    ssig12w = s122 + s123
    ssig121 = (s121 + s123) * P111
    ssig122 = (s122 + s124) * P111

    csigpne = P111 * sp1 + ssigp2 + P027 * sp3
    csigpnw = P111 * sp2 + ssigp1 + P027 * sp4
    csigpsw = P111 * sp3 + ssigp2 + P027 * sp1
    csigpse = P111 * sp4 + ssigp1 + P027 * sp2

    csigmne = P111 * sm1 + ssigm2 + P027 * sm3
    csigmnw = P111 * sm2 + ssigm1 + P027 * sm4
    csigmsw = P111 * sm3 + ssigm2 + P027 * sm1
    csigmse = P111 * sm4 + ssigm1 + P027 * sm2

    csig12ne = P222 * s121 + ssig122 + P055 * s123
    csig12nw = P222 * s122 + ssig121 + P055 * s124
    csig12sw = P222 * s123 + ssig122 + P055 * s121
    csig12se = P222 * s124 + ssig121 + P055 * s122

    str12ew = P5 * dxT * (P333 * ssig12e + P166 * ssig12w)
    str12we = P5 * dxT * (P333 * ssig12w + P166 * ssig12e)
    str12ns = P5 * dyT * (P333 * ssig12n + P166 * ssig12s)
    str12sn = P5 * dyT * (P333 * ssig12s + P166 * ssig12n)

    # u-momentum contributions of this T cell to its 4 corners
    strp = P25 * dyT * (P333 * ssigpn + P166 * ssigps)
    strm = P25 * dyT * (P333 * ssigmn + P166 * ssigms)
    str1 = -strp - strm - str12ew + dxhy * (-csigpne + csigmne) + \
        dyhx * csig12ne
    str2 = strp + strm - str12we + dxhy * (-csigpnw + csigmnw) + \
        dyhx * csig12nw
    strp = P25 * dyT * (P333 * ssigps + P166 * ssigpn)
    strm = P25 * dyT * (P333 * ssigms + P166 * ssigmn)
    str3 = -strp - strm + str12ew + dxhy * (-csigpse + csigmse) + \
        dyhx * csig12se
    str4 = strp + strm + str12we + dxhy * (-csigpsw + csigmsw) + \
        dyhx * csig12sw

    # v-momentum contributions
    strp = P25 * dxT * (P333 * ssigpe + P166 * ssigpw)
    strm = P25 * dxT * (P333 * ssigme + P166 * ssigmw)
    str5 = -strp + strm - str12ns - dyhx * (csigpne + csigmne) + \
        dxhy * csig12ne
    str6 = strp - strm - str12sn - dyhx * (csigpse + csigmse) + \
        dxhy * csig12se
    strp = P25 * dxT * (P333 * ssigpw + P166 * ssigpe)
    strm = P25 * dxT * (P333 * ssigmw + P166 * ssigme)
    str7 = -strp + strm + str12ns - dyhx * (csigpnw + csigmnw) + \
        dxhy * csig12nw
    str8 = strp - strm + str12sn - dyhx * (csigpsw + csigmsw) + \
        dxhy * csig12sw
    return str1, str2, str3, str4, str5, str6, str7, str8


def stress_divergence(grid: Grid, sp1, sp2, sp3, sp4, sm1, sm2, sm3, sm4,
                      s121, s122, s123, s124):
    """Bilinear variational divergence of the corner stresses: force per
    unit area at U points (reference `stress` + `stepu` gather,
    ice_dyn_shared.F90:948-951). U(i,j) collects from T(i,j), T east,
    T north and T northeast."""
    str1, str2, str3, str4, str5, str6, str7, str8 = stress_terms(
        grid, sp1, sp2, sp3, sp4, sm1, sm2, sm3, sm4, s121, s122, s123, s124)
    sh = lambda f, dj, di: shift(f, dj, di, bc=grid.bc, loc=FIELD_LOC_CENTER,
                                 ftype=FIELD_TYPE_SCALAR)
    strintx = grid.uarear * (str1 + sh(str2, 0, 1) + sh(str3, 1, 0) +
                             sh(str4, 1, 1))
    strinty = grid.uarear * (str5 + sh(str6, 1, 0) + sh(str7, 0, 1) +
                             sh(str8, 1, 1))
    return strintx, strinty


def evp_tail(grid: Grid, p: EvpParams, prep: DynPrep, strength, DminTarea,
             u, v, sp, sm, s12):
    """Final force diagnostics at the converged velocity: one more
    `stress_update` for (strintx, strinty) — the stress state stays at
    ndte — and the seabed stress (taubx, tauby)."""
    _, _, _, strintx, strinty = stress_update(
        grid, p, strength, DminTarea, u, v, sp, sm, s12, prep.iceTmask)
    Cb = prep.TbU / (torch.sqrt(u ** 2 + v ** 2) + cst.u0)
    return strintx, strinty, -u * Cb, -v * Cb


def evp_solve(grid: Grid, p: EvpParams, prep: DynPrep, strength,
              stressp, stressm, stress12, *, uocn, vocn):
    """Run the full EVP subcycle loop (reference ice_dyn_evp.F90:859-931).

    Returns (uvel, vvel, stressp, stressm, stress12, strintx, strinty,
    taubx, tauby)."""
    DminTarea = p.deltaminEVP * grid.tarea
    m3 = prep.iceTmask[None]
    u, v = prep.uvel, prep.vvel
    sp = torch.where(m3, stressp, 0.0)
    sm = torch.where(m3, stressm, 0.0)
    s12 = torch.where(m3, stress12, 0.0)
    for _ in range(p.ndte):
        sp, sm, s12, strintx, strinty = stress_update(
            grid, p, strength, DminTarea, u, v, sp, sm, s12, prep.iceTmask)
        u, v, _, _ = stepu_dense(u, v, strintx, strinty, prep, p, uocn, vocn)
    strintx, strinty, taubx, tauby = evp_tail(
        grid, p, prep, strength, DminTarea, u, v, sp, sm, s12)
    return u, v, sp, sm, s12, strintx, strinty, taubx, tauby


def evp_ocean_stress(prep: DynPrep, uvel, vvel, uocn, vocn):
    """Ice-ocean stress at U points for the coupler (dyn_finish)."""
    vrel = prep.aiU * cst.rhow * prep.Cw * torch.sqrt((uocn - uvel) ** 2 +
                                                      (vocn - vvel) ** 2)
    sgn = torch.sign(torch.where(prep.fm == 0, 1.0, prep.fm))
    strocnx = vrel * ((uocn - uvel) * cst.cosw -
                      (vocn - vvel) * cst.sinw * sgn)
    strocny = vrel * ((vocn - vvel) * cst.cosw +
                      (uocn - uvel) * cst.sinw * sgn)
    return strocnx, strocny
