"""C- and CD-grid EVP dynamics (PyTorch port of cice_tpu/dynamics/evp_c.py;
reference ice_dyn_evp.F90 loop :938-1101 and :1125-1293, `stressC_T`:1758,
`stressC_U`:1898, `stressCD_T`:1978, `stressCD_U`:2088,
`div_stress_{Ex,Ey,Nx,Ny}`:2195-2416; ice_dyn_shared.F90
`strain_rates_Tdt`:2297, `strain_rates_U`:2319, `stepu_C`/`stepv_C`,
`stepuv_CD`, `deformationsC_T`:1968).

Prognostic velocities live on the faces: uvelE (x at E points) and vvelN
(y at N points); the CD grid carries both components at both faces. The
`ndte` subcycles are a Python loop of dense tensor operations: no CUDA
kernel computes them (K1 is the B-grid solve).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as cst
from ..constants import (FIELD_LOC_CENTER, FIELD_LOC_EFACE, FIELD_LOC_NFACE,
                         FIELD_LOC_NECORNER, FIELD_TYPE_SCALAR,
                         FIELD_TYPE_VECTOR)
from ..core.grid import Grid, grid_average_X2Y
from ..core.halo import shift
from .common import RHEO_AREA_MIN, EvpParams, visc_replpress


def _shT(f, dj, di, bc):
    return shift(f, dj, di, bc=bc, loc=FIELD_LOC_CENTER,
                 ftype=FIELD_TYPE_SCALAR)


def _shE(f, dj, di, bc, vec=True):
    return shift(f, dj, di, bc=bc, loc=FIELD_LOC_EFACE,
                 ftype=FIELD_TYPE_VECTOR if vec else FIELD_TYPE_SCALAR)


def _shN(f, dj, di, bc, vec=True):
    return shift(f, dj, di, bc=bc, loc=FIELD_LOC_NFACE,
                 ftype=FIELD_TYPE_VECTOR if vec else FIELD_TYPE_SCALAR)


def _shU(f, dj, di, bc, vec=False):
    return shift(f, dj, di, bc=bc, loc=FIELD_LOC_NECORNER,
                 ftype=FIELD_TYPE_VECTOR if vec else FIELD_TYPE_SCALAR)


def _sgn(fm):
    return torch.sign(torch.where(fm == 0, 1.0, fm))


def strain_rates_T_c(grid: Grid, uvelE, vvelN):
    """divT, tensionT (x area) from face velocities (strain_rates_Tdt).
    Metric divisors are max-guarded as in the reference package."""
    bc = grid.bc
    uE_w = _shE(uvelE, 0, -1, bc)
    vN_s = _shN(vvelN, -1, 0, bc)
    dyE_w = _shT(grid.dyE, 0, -1, bc)
    dxN_s = _shT(grid.dxN, -1, 0, bc)
    divT = (grid.dyE * uvelE - dyE_w * uE_w +
            grid.dxN * vvelN - dxN_s * vN_s)
    tensionT = (grid.dyT ** 2 * (uvelE / torch.clamp(grid.dyE, min=1.0) -
                                 uE_w / torch.clamp(dyE_w, min=1.0)) -
                grid.dxT ** 2 * (vvelN / torch.clamp(grid.dxN, min=1.0) -
                                 vN_s / torch.clamp(dxN_s, min=1.0)))
    return divT, tensionT


def strain_rates_U_c(grid: Grid, uvelE, vvelE, uvelN, vvelN, uvelU, vvelU):
    """divergU, tensionU, shearU (x area) at U points with the masked
    one-sided boundary closures (strain_rates_U)."""
    bc = grid.bc
    npm, epm = grid.npm, grid.epm
    dxN, dyE, dxE, dyN, dxU, dyU = (grid.dxN, grid.dyE, grid.dxE, grid.dyN,
                                    grid.dxU, grid.dyU)
    uN_e = _shN(uvelN, 0, 1, bc)
    vN_e = _shN(vvelN, 0, 1, bc)
    uE_n = _shE(uvelE, 1, 0, bc)
    vE_n = _shE(vvelE, 1, 0, bc)
    npm_e = _shU(npm, 0, 1, bc)
    epm_n = _shU(epm, 1, 0, bc)
    dxN_e = _shT(dxN, 0, 1, bc)
    dyE_n = _shT(dyE, 1, 0, bc)
    ratiodxN = -dxN_e / torch.clamp(dxN, min=1.0)
    ratiodxNr = -dxN / torch.clamp(dxN_e, min=1.0)
    ratiodyE = -dyE_n / torch.clamp(dyE, min=1.0)
    ratiodyEr = -dyE / torch.clamp(dyE_n, min=1.0)

    def bc_pair(f, f_nbr, m, m_nbr, ratio, ratio_r):
        """(value at i+1, value at i) with the masked one-sided reflection."""
        f_p = f_nbr * m_nbr + (m - m_nbr) * m * ratio * f
        f_0 = f * m + (m_nbr - m) * m_nbr * ratio_r * f_nbr
        return f_p, f_0

    uNip1j, uNij = bc_pair(uvelN, uN_e, npm, npm_e, ratiodxN, ratiodxNr)
    vEijp1, vEij = bc_pair(vvelE, vE_n, epm, epm_n, ratiodyE, ratiodyEr)
    uEijp1, uEij = bc_pair(uvelE, uE_n, epm, epm_n, ratiodyE, ratiodyEr)
    vNip1j, vNij = bc_pair(vvelN, vN_e, npm, npm_e, ratiodxN, ratiodxNr)

    dyN_e = _shT(dyN, 0, 1, bc)
    dxE_n = _shT(dxE, 1, 0, bc)
    divergU = (dyU * (uNip1j - uNij) + uvelU * (dyN_e - dyN) +
               dxU * (vEijp1 - vEij) + vvelU * (dxE_n - dxE))
    tensionU = (dyU * (uNip1j - uNij) - uvelU * (dyN_e - dyN) -
                dxU * (vEijp1 - vEij) + vvelU * (dxE_n - dxE))
    shearU = (dxU * (uEijp1 - uEij) - uvelU * (dxE_n - dxE) +
              dyU * (vNip1j - vNij) - vvelU * (dyN_e - dyN))
    return divergU, tensionU, shearU


class CPrep(NamedTuple):
    """Momentum-equation inputs at E and N points."""
    iceTmask: torch.Tensor
    iceEmask: torch.Tensor
    iceNmask: torch.Tensor
    aiE: torch.Tensor
    aiN: torch.Tensor
    emassdti: torch.Tensor
    nmassdti: torch.Tensor
    fmE: torch.Tensor
    fmN: torch.Tensor
    waterxE: torch.Tensor
    wateryN: torch.Tensor
    forcexE: torch.Tensor
    forceyN: torch.Tensor
    uocnE: torch.Tensor
    vocnE: torch.Tensor
    uocnN: torch.Tensor
    vocnN: torch.Tensor
    uvelE_init: torch.Tensor
    vvelN_init: torch.Tensor
    TbE: torch.Tensor
    TbN: torch.Tensor
    Cw: torch.Tensor


def dyn_prep_c(grid: Grid, cfg_dyn, dt: float, *, aice, vice, vsno,
               uvelE, vvelN, strairxT, strairyT, uocn_T, vocn_T) -> CPrep:
    """T -> E/N interpolation of mass, forcing and currents (the C-grid
    section at the top of evp(), ice_dyn_evp.F90)."""
    tmass = cst.rhoi * vice + cst.rhos * vsno
    tmphm = grid.tmask & (aice > 1e-11) & (tmass > 1e-10)
    bc = grid.bc
    tmphm_f = tmphm.to(torch.float32)
    near = tmphm
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if dj or di:
                near = near | (_shT(tmphm_f, dj, di, bc) > 0.5)
    iceTmask = near & grid.tmask

    def toE(f, kind="S"):
        return grid_average_X2Y(kind, f, "T", "E", grid)

    def toN(f, kind="S"):
        return grid_average_X2Y(kind, f, "T", "N", grid)

    aiE, aiN = toE(aice), toN(aice)
    emass, nmass = toE(tmass), toN(tmass)
    uocnE, vocnE = toE(uocn_T), toE(vocn_T)
    uocnN, vocnN = toN(uocn_T), toN(vocn_T)
    strairxE = toE(strairxT, "F")
    strairyN = toN(strairyT, "F")

    iceEmask = (grid.epm > 0.5) & (aiE > 1e-11) & (emass > 1e-10)
    iceNmask = (grid.npm > 0.5) & (aiN > 1e-11) & (nmass > 1e-10)

    emassdti = torch.where(iceEmask, emass / dt, 0.0)
    nmassdti = torch.where(iceNmask, nmass / dt, 0.0)
    latE = 0.5 * (grid.TLAT + _shT(grid.TLAT, 0, 1, bc))
    latN = 0.5 * (grid.TLAT + _shT(grid.TLAT, 1, 0, bc))
    if cfg_dyn.coriolis == "constant":
        fE = torch.full_like(latE, 1.46e-4)
        fN = torch.full_like(latN, 1.46e-4)
    elif cfg_dyn.coriolis == "zero":
        fE = torch.zeros_like(latE)
        fN = torch.zeros_like(latN)
    else:
        fE = 2.0 * cst.omega * torch.sin(latE)
        fN = 2.0 * cst.omega * torch.sin(latN)
    fmE = torch.where(iceEmask, fE * emass, 0.0)
    fmN = torch.where(iceNmask, fN * nmass, 0.0)

    sgnE, sgnN = _sgn(fmE), _sgn(fmN)
    waterxE = torch.where(iceEmask,
                          uocnE * cst.cosw - vocnE * cst.sinw * sgnE, 0.0)
    wateryN = torch.where(iceNmask,
                          vocnN * cst.cosw + uocnN * cst.sinw * sgnN, 0.0)
    forcexE = torch.where(iceEmask, strairxE - fmE * vocnE, 0.0)
    forceyN = torch.where(iceNmask, strairyN + fmN * uocnN, 0.0)

    uvelE = torch.where(iceEmask, uvelE, 0.0)
    vvelN = torch.where(iceNmask, vvelN, 0.0)

    if cfg_dyn.seabed_stress:
        TbE = seabed_stress_LKD_face(grid, cfg_dyn, aice, vice, iceEmask, "E")
        TbN = seabed_stress_LKD_face(grid, cfg_dyn, aice, vice, iceNmask, "N")
    else:
        TbE = torch.zeros_like(aiE)
        TbN = torch.zeros_like(aiN)

    return CPrep(iceTmask=iceTmask, iceEmask=iceEmask, iceNmask=iceNmask,
                 aiE=aiE, aiN=aiN, emassdti=emassdti, nmassdti=nmassdti,
                 fmE=fmE, fmN=fmN, waterxE=waterxE, wateryN=wateryN,
                 forcexE=forcexE, forceyN=forceyN,
                 uocnE=uocnE, vocnE=vocnE, uocnN=uocnN, vocnN=vocnN,
                 uvelE_init=uvelE, vvelN_init=vvelN, TbE=TbE, TbN=TbN,
                 Cw=torch.full_like(aiE, cst.dragio))


class CDPrepExtra(NamedTuple):
    """The CD grid's further E/N-point momentum inputs (both velocity
    components live at both faces; reference stepuv_CD)."""
    forceyE: torch.Tensor
    wateryE: torch.Tensor
    forcexN: torch.Tensor
    waterxN: torch.Tensor
    vvelE_init: torch.Tensor
    uvelN_init: torch.Tensor


def dyn_prep_cd(grid: Grid, cfg_dyn, dt: float, prep: CPrep, *,
                vvelE, uvelN, strairxT, strairyT) -> CDPrepExtra:
    """The CD-grid extras on top of dyn_prep_c: y-forcing at E points and
    x-forcing at N points."""
    strairyE = grid_average_X2Y("F", strairyT, "T", "E", grid)
    strairxN = grid_average_X2Y("F", strairxT, "T", "N", grid)
    sgnE, sgnN = _sgn(prep.fmE), _sgn(prep.fmN)
    wateryE = torch.where(prep.iceEmask, prep.vocnE * cst.cosw +
                          prep.uocnE * cst.sinw * sgnE, 0.0)
    waterxN = torch.where(prep.iceNmask, prep.uocnN * cst.cosw -
                          prep.vocnN * cst.sinw * sgnN, 0.0)
    forceyE = torch.where(prep.iceEmask, strairyE + prep.fmE * prep.uocnE,
                          0.0)
    forcexN = torch.where(prep.iceNmask, strairxN - prep.fmN * prep.vocnN,
                          0.0)
    return CDPrepExtra(forceyE=forceyE, wateryE=wateryE, forcexN=forcexN,
                       waterxN=waterxN,
                       vvelE_init=torch.where(prep.iceEmask, vvelE, 0.0),
                       uvelN_init=torch.where(prep.iceNmask, uvelN, 0.0))


def _inv_area(area):
    return torch.where(area > 0, 1.0 / torch.clamp(area, min=1.0), 0.0)


def c_stress_divergence(grid: Grid, spT, smT, s12U):
    """strintxE / strintyN from the C-grid stress state (div_stress_Ex /
    div_stress_Ny)."""
    bc = grid.bc
    spT_e = _shE(spT, 0, 1, bc, vec=False)
    smT_e = _shE(smT, 0, 1, bc, vec=False)
    dyT_e = _shT(grid.dyT, 0, 1, bc)
    s12_s = _shE(s12U, -1, 0, bc, vec=False)
    dxU_s = _shT(grid.dxU, -1, 0, bc)
    strintxE = _inv_area(grid.earea) * (
        0.5 * grid.dyE * (spT_e - spT)
        + (0.5 / torch.clamp(grid.dyE, min=1.0)) *
        (dyT_e ** 2 * smT_e - grid.dyT ** 2 * smT)
        + (1.0 / torch.clamp(grid.dxE, min=1.0)) *
        (grid.dxU ** 2 * s12U - dxU_s ** 2 * s12_s))

    spT_n = _shN(spT, 1, 0, bc, vec=False)
    smT_n = _shN(smT, 1, 0, bc, vec=False)
    dxT_n = _shT(grid.dxT, 1, 0, bc)
    s12_w = _shN(s12U, 0, -1, bc, vec=False)
    dyU_w = _shT(grid.dyU, 0, -1, bc)
    strintyN = _inv_area(grid.narea) * (
        0.5 * grid.dxN * (spT_n - spT)
        - (0.5 / torch.clamp(grid.dxN, min=1.0)) *
        (dxT_n ** 2 * smT_n - grid.dxT ** 2 * smT)
        + (1.0 / torch.clamp(grid.dyN, min=1.0)) *
        (grid.dyU ** 2 * s12U - dyU_w ** 2 * s12_w))
    return strintxE, strintyN


def _uarea_ring(grid: Grid):
    """uarea at U(i,j), its west, south and southwest neighbours."""
    bc, ua = grid.bc, grid.uarea
    return ua, _shU(ua, 0, -1, bc), _shU(ua, -1, 0, bc), _shU(ua, -1, -1, bc)


def _shear_to_T(grid: Grid, shearU, ring, square=False):
    """Area-weighted average of the four U-point shears around a T cell
    (of their squares with `square`)."""
    bc = grid.bc
    ua, ua_w, ua_s, ua_sw = ring
    sh = [shearU, _shU(shearU, 0, -1, bc), _shU(shearU, -1, 0, bc),
          _shU(shearU, -1, -1, bc)]
    if square:
        sh = [s ** 2 for s in sh]
    den = torch.clamp(ua + ua_w + ua_s + ua_sw, min=1.0)
    return (sh[0] * ua + sh[1] * ua_w + sh[2] * ua_s + sh[3] * ua_sw) / den


def deformations_C(grid: Grid, uvelE, vvelN, p: EvpParams):
    """divu, shear, Delta at T points from the C-grid strain rates
    (deformationsC_T): T-point divergence and tension plus the
    area-averaged U-point shear."""
    vvelE = grid_average_X2Y("S", vvelN, "N", "E", grid)
    uvelN = grid_average_X2Y("S", uvelE, "E", "N", grid)
    uvelU = grid_average_X2Y("S", uvelE, "E", "U", grid)
    vvelU = grid_average_X2Y("S", vvelN, "N", "U", grid)
    _, _, shearU = strain_rates_U_c(grid, uvelE, vvelE, uvelN, vvelN,
                                    uvelU, vvelU)
    divT, tensionT = strain_rates_T_c(grid, uvelE, vvelN)
    shearT = _shear_to_T(grid, shearU, _uarea_ring(grid))
    tarear = grid.tarear
    divu = divT * tarear
    shear = torch.sqrt(tensionT ** 2 + shearT ** 2) * tarear
    Delta = torch.sqrt(divT ** 2 + p.e_factor * (tensionT ** 2 +
                                                 shearT ** 2)) * tarear
    return divu, shear, Delta


def seabed_stress_LKD_face(grid: Grid, cfg_dyn, aice, vice, mask, face: str):
    """Lemieux et al. landfast seabed stress factor at E or N points
    (seabed_stress_factor_LKD at grid_ice C/CD: the two T cells beside
    the face instead of the U point's four)."""
    bc = grid.bc
    offs = [(0, 0), (0, 1)] if face == "E" else [(0, 0), (1, 0)]
    hw2 = [_shT(grid.bathymetry, dj, di, bc) for dj, di in offs]
    hwf = torch.stack([torch.where(h > 0, h, 1e30) for h in hw2]).amin(0)
    af = torch.stack([_shT(aice, dj, di, bc) for dj, di in offs]).amax(0)
    hf = torch.stack([_shT(vice, dj, di, bc) for dj, di in offs]).amax(0)
    docalc = (hwf < cfg_dyn.threshold_hw) & mask
    hcf = af * hwf / cfg_dyn.k1
    Tb = cfg_dyn.k2 * torch.clamp(hf - hcf, min=0.0) * \
        torch.exp(-cfg_dyn.alphab * (1.0 - af))
    return torch.where(docalc, Tb, 0.0)


#: the native E/N-point planes of `c_dyn_finish`
EN_PLANES = ("strintxE", "strintyN", "taubxE", "taubyN", "strocnxE",
             "strocnyE", "strocnxN", "strocnyN")


def c_dyn_finish(grid: Grid, prep: CPrep, uvelE, vvelN, spT, smT, s12U,
                 *, vvelE=None, uvelN=None):
    """The coupler and diagnostic exports after the subcycles (dyn_finish
    at E/N points and the U-point averages, ice_dyn_evp.F90:1380-1445):
    U-point strintx/y, taubx/y, strocnx/y (the planes the B path exports:
    x from the E points, y from the N points) and the native E/N planes
    (EN_PLANES)."""
    if vvelE is None:
        vvelE = grid_average_X2Y("S", vvelN, "N", "E", grid)
    if uvelN is None:
        uvelN = grid_average_X2Y("S", uvelE, "E", "N", grid)

    strintxE, strintyN = c_stress_divergence(grid, spT, smT, s12U)

    CbE = prep.TbE / (torch.sqrt(uvelE ** 2 + vvelE ** 2) + cst.u0)
    CbN = prep.TbN / (torch.sqrt(uvelN ** 2 + vvelN ** 2) + cst.u0)
    taubxE = -uvelE * CbE
    taubyN = -vvelN * CbN

    def strocn(u, v, uocn, vocn, ai, fm):
        vrel = ai * cst.rhow * prep.Cw * torch.sqrt((uocn - u) ** 2 +
                                                    (vocn - v) ** 2)
        sgn = _sgn(fm)
        sx = vrel * ((uocn - u) * cst.cosw - (vocn - v) * cst.sinw * sgn)
        sy = vrel * ((vocn - v) * cst.cosw + (uocn - u) * cst.sinw * sgn)
        return sx, sy

    strocnxE, strocnyE = strocn(uvelE, vvelE, prep.uocnE, prep.vocnE,
                                prep.aiE, prep.fmE)
    strocnxN, strocnyN = strocn(uvelN, vvelN, prep.uocnN, prep.vocnN,
                                prep.aiN, prep.fmN)

    toU_E = lambda f: grid_average_X2Y("S", f, "E", "U", grid)
    toU_N = lambda f: grid_average_X2Y("S", f, "N", "U", grid)
    out = dict(
        strintx=toU_E(strintxE), strinty=toU_N(strintyN),
        taubx=toU_E(taubxE), tauby=toU_N(taubyN),
        strocnx=toU_E(strocnxE), strocny=toU_N(strocnyN),
        strintxE=strintxE, strintyN=strintyN,
        taubxE=taubxE, taubyN=taubyN,
        strocnxE=strocnxE, strocnyE=strocnyE,
        strocnxN=strocnxN, strocnyN=strocnyN)
    return out


def cd_cross_planes(grid: Grid, prep: CPrep, st: "CDEvpState"):
    """The CD grid's cross components at the converged state: strintyE,
    strintxN (the divergence of the U-point normal stresses and the T-point
    shear, without the rheology cutoff, as c_dyn_finish's strintxE) and
    the seabed stresses taubyE, taubxN."""
    strintyE, strintxN = _cd_cross_divergence(
        grid, st.stresspU, st.stressmU, st.stress12T)
    CbE = prep.TbE / (torch.sqrt(st.uvelE ** 2 + st.vvelE ** 2) + cst.u0)
    CbN = prep.TbN / (torch.sqrt(st.uvelN ** 2 + st.vvelN ** 2) + cst.u0)
    return dict(strintyE=strintyE, strintxN=strintxN,
                taubyE=-st.vvelE * CbE, taubxN=-st.uvelN * CbN)


class CEvpState(NamedTuple):
    uvelE: torch.Tensor
    vvelN: torch.Tensor
    stresspT: torch.Tensor
    stressmT: torch.Tensor
    stress12U: torch.Tensor


def _tarea_ring(grid: Grid):
    """tarea at T(i,j) and its east, north and northeast neighbours, on
    the U point between them."""
    bc, ta = grid.bc, grid.tarea
    return ta, _shU(ta, 0, 1, bc), _shU(ta, 1, 0, bc), _shU(ta, 1, 1, bc)


def _T_to_U(grid: Grid, f, tring):
    """Area-weighted average of the four T cells around each U point."""
    bc = grid.bc
    ta, ta_e, ta_n, ta_ne = tring
    return (f * ta + _shU(f, 0, 1, bc) * ta_e + _shU(f, 1, 0, bc) * ta_n +
            _shU(f, 1, 1, bc) * ta_ne) / \
        torch.clamp(ta + ta_e + ta_n + ta_ne, min=1.0)


def c_subcycle_step(grid: Grid, p: EvpParams, prep: CPrep, strength,
                    DminTarea, st: CEvpState, rings) -> CEvpState:
    """One C-grid elastic subcycle: stresses at T and U points, then the u
    momentum at E and the v momentum at N points. `rings` is
    (_uarea_ring(grid), _tarea_ring(grid)), made once per solve."""
    c1m = 1.0 - p.arlx1i * p.revp
    a1, d1 = p.arlx1i, p.denom1
    uring, tring = rings

    uvelE, vvelN = st.uvelE, st.vvelN
    vvelE = grid_average_X2Y("S", vvelN, "N", "E", grid)
    uvelN = grid_average_X2Y("S", uvelE, "E", "N", grid)
    uvelU = grid_average_X2Y("S", uvelE, "E", "U", grid)
    vvelU = grid_average_X2Y("S", vvelN, "N", "U", grid)
    _, _, shearU = strain_rates_U_c(grid, uvelE, vvelE, uvelN, vvelN,
                                    uvelU, vvelU)

    # T-point stress (stressC_T)
    divT, tensionT = strain_rates_T_c(grid, uvelE, vvelN)
    shearTsqr = _shear_to_T(grid, shearU, uring, square=True)
    DeltaT = torch.sqrt(divT ** 2 + p.e_factor * (tensionT ** 2 + shearTsqr))
    zetax2T, etax2T, rep_prsT = visc_replpress(strength, DminTarea, DeltaT,
                                               p)
    m = prep.iceTmask
    spT = torch.where(m, (st.stresspT * c1m +
                          a1 * (zetax2T * divT - rep_prsT)) * d1, st.stresspT)
    smT = torch.where(m, (st.stressmT * c1m +
                          a1 * etax2T * tensionT) * d1, st.stressmT)

    # U-point stress12 (stressC_U, visc_method='avg_zeta')
    etax2U = _T_to_U(grid, etax2T, tring)
    s12U = (st.stress12U * c1m + a1 * 0.5 * etax2U * shearU) * d1

    # stress divergence at E (x) and N (y), with the rheology cutoff at
    # near-massless face points (rheofactE/N, rheo_area_min)
    strintxE, strintyN = c_stress_divergence(grid, spT, smT, s12U)
    strintxE = strintxE * (prep.aiE > RHEO_AREA_MIN).to(strintxE.dtype)
    strintyN = strintyN * (prep.aiN > RHEO_AREA_MIN).to(strintyN.dtype)

    # momentum: u at E (stepu_C), v at N (stepv_C); the transverse
    # velocity explicit by interpolation
    vold_E = vvelE
    uold_N = uvelN
    vrelE = prep.aiE * cst.rhow * prep.Cw * torch.sqrt(
        (prep.uocnE - uvelE) ** 2 + (prep.vocnE - vold_E) ** 2)
    CbE = prep.TbE / (torch.sqrt(uvelE ** 2 + vold_E ** 2) + cst.u0)
    ccaE = (p.brlx + p.revp) * prep.emassdti + vrelE * cst.cosw + CbE
    ccbE = prep.fmE + _sgn(prep.fmE) * vrelE * cst.sinw
    cc1 = strintxE + prep.forcexE + vrelE * prep.waterxE \
        + prep.emassdti * (p.brlx * uvelE + p.revp * prep.uvelE_init)
    uE_new = torch.where(prep.iceEmask, (ccbE * vold_E + cc1) /
                         torch.where(prep.iceEmask, ccaE, 1.0), 0.0)

    vrelN = prep.aiN * cst.rhow * prep.Cw * torch.sqrt(
        (prep.uocnN - uold_N) ** 2 + (prep.vocnN - vvelN) ** 2)
    CbN = prep.TbN / (torch.sqrt(uold_N ** 2 + vvelN ** 2) + cst.u0)
    ccaN = (p.brlx + p.revp) * prep.nmassdti + vrelN * cst.cosw + CbN
    ccbN = prep.fmN + _sgn(prep.fmN) * vrelN * cst.sinw
    cc2 = strintyN + prep.forceyN + vrelN * prep.wateryN \
        + prep.nmassdti * (p.brlx * vvelN + p.revp * prep.vvelN_init)
    vN_new = torch.where(prep.iceNmask, (-ccbN * uold_N + cc2) /
                         torch.where(prep.iceNmask, ccaN, 1.0), 0.0)
    return CEvpState(uE_new, vN_new, spT, smT, s12U)


def evp_c_solve(grid: Grid, p: EvpParams, prep: CPrep, strength,
                stresspT, stressmT, stress12U):
    """The C-grid EVP subcycle loop (ice_dyn_evp.F90:938-1101). Returns
    (final CEvpState, uvelU, vvelU): the corner velocities for transport
    and coupling."""
    DminTarea = p.deltaminEVP * grid.tarea
    st = CEvpState(prep.uvelE_init, prep.vvelN_init,
                   torch.where(prep.iceTmask, stresspT, 0.0),
                   torch.where(prep.iceTmask, stressmT, 0.0), stress12U)
    rings = (_uarea_ring(grid), _tarea_ring(grid))
    for _ in range(p.ndte):
        st = c_subcycle_step(grid, p, prep, strength, DminTarea, st, rings)
    uvelU = grid_average_X2Y("S", st.uvelE, "E", "U", grid)
    vvelU = grid_average_X2Y("S", st.vvelN, "N", "U", grid)
    return st, uvelU, vvelU


class CDEvpState(NamedTuple):
    """The CD grid's prognostic set: both velocity components at both
    faces, the stress tensor at T and at U points."""
    uvelE: torch.Tensor
    vvelE: torch.Tensor
    uvelN: torch.Tensor
    vvelN: torch.Tensor
    stresspT: torch.Tensor
    stressmT: torch.Tensor
    stress12T: torch.Tensor
    stresspU: torch.Tensor
    stressmU: torch.Tensor
    stress12U: torch.Tensor


def _cd_cross_divergence(grid: Grid, spU, smU, s12T):
    """(strintyE, strintxN): div_stress_Ey and div_stress_Nx, from the
    U-point normal stresses and the T-point shear."""
    bc = grid.bc
    dyT_e = _shT(grid.dyT, 0, 1, bc)
    dxU_s = _shT(grid.dxU, -1, 0, bc)
    dxT_n = _shT(grid.dxT, 1, 0, bc)
    dyU_w = _shT(grid.dyU, 0, -1, bc)
    spU_s = _shE(spU, -1, 0, bc, vec=False)
    smU_s = _shE(smU, -1, 0, bc, vec=False)
    s12T_e = _shE(s12T, 0, 1, bc, vec=False)
    strintyE = _inv_area(grid.earea) * (
        0.5 * grid.dxE * (spU - spU_s)
        - (0.5 / grid.dxE) * (grid.dxU ** 2 * smU - dxU_s ** 2 * smU_s)
        + (1.0 / grid.dyE) * (dyT_e ** 2 * s12T_e - grid.dyT ** 2 * s12T))
    spU_w = _shN(spU, 0, -1, bc, vec=False)
    smU_w = _shN(smU, 0, -1, bc, vec=False)
    s12T_n = _shN(s12T, 1, 0, bc, vec=False)
    strintxN = _inv_area(grid.narea) * (
        0.5 * grid.dyN * (spU - spU_w)
        + (0.5 / grid.dyN) * (grid.dyU ** 2 * smU - dyU_w ** 2 * smU_w)
        + (1.0 / grid.dxN) * (dxT_n ** 2 * s12T_n - grid.dxT ** 2 * s12T))
    return strintyE, strintxN


def _cd_subcycle(grid: Grid, p: EvpParams, prep: CPrep, extra: CDPrepExtra,
                 strength, DminTarea, DminUarea, uring, tring,
                 st: CDEvpState) -> CDEvpState:
    """One CD-grid elastic subcycle. The area averages and metric divisors
    share the C grid's guards (max(., 1)): the reference package leaves
    them unguarded here, which differs only where an area or a metric is
    below 1 m^2 or 1 m, and there it divides by zero."""
    c1m = 1.0 - p.arlx1i * p.revp
    a1, d1 = p.arlx1i, p.denom1

    uvelE, vvelE, uvelN, vvelN = st.uvelE, st.vvelE, st.uvelN, st.vvelN
    uvelU = grid_average_X2Y("S", uvelE, "E", "U", grid)
    vvelU = grid_average_X2Y("S", vvelN, "N", "U", grid)
    divU, tenU, shearU = strain_rates_U_c(grid, uvelE, vvelE, uvelN, vvelN,
                                          uvelU, vvelU)

    # T-point stresses (stressCD_T: the full tensor)
    divT, tensionT = strain_rates_T_c(grid, uvelE, vvelN)
    shearT = _shear_to_T(grid, shearU, uring)
    DeltaT = torch.sqrt(divT ** 2 + p.e_factor * (tensionT ** 2 +
                                                  shearT ** 2))
    zetax2T, etax2T, rep_prsT = visc_replpress(strength, DminTarea, DeltaT,
                                               p)
    m = prep.iceTmask
    spT = torch.where(m, (st.stresspT * c1m +
                          a1 * (zetax2T * divT - rep_prsT)) * d1, st.stresspT)
    smT = torch.where(m, (st.stressmT * c1m +
                          a1 * etax2T * tensionT) * d1, st.stressmT)
    s12T = torch.where(m, (st.stress12T * c1m +
                           a1 * 0.5 * etax2T * shearT) * d1, st.stress12T)

    # U-point stresses (stressCD_U, visc_method='avg_zeta')
    strU = _T_to_U(grid, strength, tring)
    DeltaU = torch.sqrt(divU ** 2 + p.e_factor * (tenU ** 2 + shearU ** 2))
    zetax2U, etax2U, rep_prsU = visc_replpress(strU, DminUarea, DeltaU, p)
    spU = (st.stresspU * c1m + a1 * (zetax2U * divU - rep_prsU)) * d1
    smU = (st.stressmU * c1m + a1 * etax2U * tenU) * d1
    s12U = (st.stress12U * c1m + a1 * 0.5 * etax2U * shearU) * d1

    # the four stress divergences: Ex and Ny as on the C grid, Ey and Nx
    # from the U-point normal stresses and the T-point shear
    strintxE, strintyN = c_stress_divergence(grid, spT, smT, s12U)
    strintyE, strintxN = _cd_cross_divergence(grid, spU, smU, s12T)

    rfE = (prep.aiE > RHEO_AREA_MIN).to(strintxE.dtype)
    rfN = (prep.aiN > RHEO_AREA_MIN).to(strintyN.dtype)
    strintxE = strintxE * rfE
    strintyE = strintyE * rfE
    strintyN = strintyN * rfN
    strintxN = strintxN * rfN

    # momentum: an implicit 2x2 point solve at E and at N (stepuv_CD)
    def step2(u, v, ai, uocn, vocn, Tb, massdti, fm, mask, c_u, c_v):
        vrel = ai * cst.rhow * prep.Cw * torch.sqrt((uocn - u) ** 2 +
                                                    (vocn - v) ** 2)
        Cb = Tb / (torch.sqrt(u ** 2 + v ** 2) + cst.u0)
        cca = (p.brlx + p.revp) * massdti + vrel * cst.cosw + Cb
        cca = torch.where(mask, cca, 1.0)
        ccb = fm + _sgn(fm) * vrel * cst.sinw
        c1, c2 = c_u(vrel), c_v(vrel)
        det = cca ** 2 + ccb ** 2
        return (torch.where(mask, (cca * c1 + ccb * c2) / det, 0.0),
                torch.where(mask, (cca * c2 - ccb * c1) / det, 0.0))

    uE_new, vE_new = step2(
        uvelE, vvelE, prep.aiE, prep.uocnE, prep.vocnE, prep.TbE,
        prep.emassdti, prep.fmE, prep.iceEmask,
        lambda vrel: strintxE + prep.forcexE + vrel * prep.waterxE
        + prep.emassdti * (p.brlx * uvelE + p.revp * prep.uvelE_init),
        lambda vrel: strintyE + extra.forceyE + vrel * extra.wateryE
        + prep.emassdti * (p.brlx * vvelE + p.revp * extra.vvelE_init))
    uN_new, vN_new = step2(
        uvelN, vvelN, prep.aiN, prep.uocnN, prep.vocnN, prep.TbN,
        prep.nmassdti, prep.fmN, prep.iceNmask,
        lambda vrel: strintxN + extra.forcexN + vrel * extra.waterxN
        + prep.nmassdti * (p.brlx * uvelN + p.revp * extra.uvelN_init),
        lambda vrel: strintyN + prep.forceyN + vrel * prep.wateryN
        + prep.nmassdti * (p.brlx * vvelN + p.revp * prep.vvelN_init))
    return CDEvpState(uE_new, vE_new, uN_new, vN_new,
                      spT, smT, s12T, spU, smU, s12U)


def evp_cd_solve(grid: Grid, p: EvpParams, prep: CPrep, extra: CDPrepExtra,
                 strength, init: CDEvpState):
    """The CD-grid EVP subcycle loop (ice_dyn_evp.F90:1125-1293):
    stresses at both T and U points, both momentum components stepped at E
    and N by an implicit 2x2 point solve. Returns (final CDEvpState,
    uvelU, vvelU)."""
    DminTarea = p.deltaminEVP * grid.tarea
    DminUarea = p.deltaminEVP * grid.uarea
    uring, tring = _uarea_ring(grid), _tarea_ring(grid)
    st = init
    for _ in range(p.ndte):
        st = _cd_subcycle(grid, p, prep, extra, strength, DminTarea,
                          DminUarea, uring, tring, st)
    uvelU = grid_average_X2Y("S", st.uvelE, "E", "U", grid)
    vvelU = grid_average_X2Y("S", st.vvelN, "N", "U", grid)
    return st, uvelU, vvelU
