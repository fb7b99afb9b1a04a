"""Delta-Eddington multiple-scattering shortwave (shortwave='dEdd*';
PyTorch port of cice_tpu/columns/dedd.py; Briegleb & Light 2007,
NCAR/TN-472+STR).

Per-category columns split into snow-covered, bare and ponded sub-columns,
each a stack of homogeneous layers with delta-scaled inherent optical
properties, solved by the analytic delta-Eddington two-stream solution per
layer and combined with the adding method.

The three solar bands ride on a leading dimension of every tensor, so each
sub-column's layer and adding recursions run once for all bands: the band
constants are (3, 1, 1, 1) tensors and each element sees the JAX package's
operations in its order. The sub-column kinds keep separate recursions,
because their layer stacks differ.

Aerosols in snow (tr_aero) darken the top snow layer with per-band optics
(vis in band 0, near-IR in bands 1-2); ice-algal chlorophyll (zbgc
dEdd_algae) adds absorption to the bottom ice layer in band 0 only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as cst
from .shortwave import ShortwaveOut

# Tabulated per-layer-class IOPs (extinction k [1/m], single-scattering
# albedo w0) on the three solar bands of Briegleb & Light (2007) Table 2:
# 0.2-0.7 um (vis), 0.7-1.19 um, 1.19-5.0 um.
NBAND = 3
K_ICE_SSL = (1000.1, 1003.7, 7042.0)
W_ICE_SSL = (0.9999, 0.9963, 0.9088)
K_ICE_DL = (100.2, 107.7, 1309.0)
W_ICE_DL = (0.9980, 0.9287, 0.0305)
K_ICE_INT = (20.2, 27.7, 1445.0)
W_ICE_INT = (0.9901, 0.7223, 0.0277)
K_PICE_SSL = (70.2, 77.7, 1309.0)       # ponded-ice SSL
W_PICE_SSL = (0.9972, 0.9009, 0.0305)
K_POND_W = (0.20, 12.0, 729.0)          # pond water absorption
G_ICE = 0.94
W_NIR = (0.67, 0.33)                    # near-IR split onto bands 1 and 2
W0_SNOW_COEF = (5.0e-4, 0.047, 1.13)    # snow w0 = 1 - c_b sqrt(reff[m])
G_SNOW = 0.89
H_SSL = 0.05        # surface scattering layer thickness (m)
H_DL = 0.05         # drained layer thickness (m)
ALB_OCEAN = 0.06    # underlying ocean albedo (all bands)
MU0_MIN = 0.05


def _bands(values, like: torch.Tensor) -> torch.Tensor:
    """A band constant as a (3, 1, 1, 1) tensor of `like`'s dtype: each
    entry rounds once from the Python double, as a weakly typed JAX
    scalar does. Uploaded once per (values, dtype, device)."""
    return _band_tensor(tuple(values), like.dtype, like.device)


@functools.lru_cache(maxsize=None)
def _band_tensor(values, dtype, device):
    return torch.as_tensor(np.asarray(values, np.float64), dtype=dtype,
                           device=device).reshape(NBAND, 1, 1, 1)


def _delta_eddington_layer(tau, w0, g, mu0):
    """Analytic delta-Eddington solution for one homogeneous layer:
    (rdir, tdir, rdif, tdif, trnlay), Briegleb & Light (2007) eqs.
    (50)-(55)."""
    f = g * g
    taus = (1.0 - w0 * f) * tau
    ws = torch.clamp((1.0 - f) * w0 / torch.clamp(1.0 - w0 * f, min=1e-12),
                     0.0, 0.999999)
    gs = g / (1.0 + g)

    lm = torch.sqrt(torch.clamp(3.0 * (1.0 - ws) * (1.0 - ws * gs),
                                min=1e-12))
    ue = 1.5 * (1.0 - ws * gs) / lm
    # avoid the lam*mu0 -> 1 resonance
    denom = 1.0 - (lm * mu0) ** 2
    denom = torch.where(
        torch.abs(denom) < 1e-6,
        torch.sign(denom) * 1e-6 + (denom == 0).to(denom.dtype) * 1e-6,
        denom)
    alp = 0.75 * ws * mu0 * (1.0 + gs * (1.0 - ws)) / denom
    gam = 0.5 * ws * (1.0 + 3.0 * gs * mu0 * mu0 * (1.0 - ws)) / denom
    apg = alp + gam
    amg = alp - gam

    extins = torch.exp(-torch.clamp(lm * taus, max=25.0))
    ne = (ue + 1.0) ** 2 / extins - (ue - 1.0) ** 2 * extins
    rdif = (ue * ue - 1.0) * (1.0 / extins - extins) / ne
    tdif = 4.0 * ue / ne

    trnlay = torch.exp(-torch.clamp(
        taus / torch.clamp(mu0, min=MU0_MIN), max=25.0))
    rdir = apg * rdif + amg * tdif * trnlay - amg
    tdir = apg * tdif + (amg * rdif - apg + 1.0) * trnlay
    rdir = torch.clamp(rdir, 0.0, 1.0)
    tdir = torch.clamp(tdir, 0.0, 1.0)
    return (rdir, tdir, torch.clamp(rdif, 0.0, 1.0),
            torch.clamp(tdif, 0.0, 1.0), trnlay)


def _adding(layers, mu0, alb_ocn):
    """Adding method over a list of (tau, w0, g) layers above the ocean.
    Returns (albdir, albdif, absdir[k], absdif[k], trandir, trandif) per
    unit incident direct / diffuse flux."""
    n = len(layers)
    props = [_delta_eddington_layer(tau, w0, g, mu0) for tau, w0, g in layers]
    shape = props[0][0].shape
    one = torch.ones(shape, dtype=mu0.dtype, device=mu0.device)
    zero = torch.zeros_like(one)
    # top-down: stack-above quantities at each interface 0..n
    trndir = [one]
    trntdr = [one]
    trndif = [one]
    rdndif = [zero]
    for k in range(n):
        rdir, tdir, rdif, tdif, trn = props[k]
        refkm1 = 1.0 / (1.0 - rdndif[k] * rdif)
        tdrrdir = trndir[k] * rdir
        tdndif = trntdr[k] - trndir[k]
        trntdr.append(trndir[k] * tdir +
                      (tdndif + tdrrdir * rdndif[k]) * refkm1 * tdif)
        rdndif.append(rdif + tdif * rdndif[k] * refkm1 * tdif)
        trndif.append(trndif[k] * refkm1 * tdif)
        trndir.append(trndir[k] * trn)

    # bottom-up: stack-below reflectivities at each interface
    rupdir = [None] * (n + 1)
    rupdif = [None] * (n + 1)
    rupdir[n] = torch.full_like(one, alb_ocn)
    rupdif[n] = torch.full_like(one, alb_ocn)
    for k in range(n - 1, -1, -1):
        rdir, tdir, rdif, tdif, trn = props[k]
        refkp1 = 1.0 / (1.0 - rdif * rupdif[k + 1])
        rupdir[k] = rdir + (trn * rupdir[k + 1] +
                            (tdir - trn) * rupdif[k + 1]) * refkp1 * tdif
        rupdif[k] = rdif + tdif * rupdif[k + 1] * refkp1 * tdif

    # interface net fluxes per unit incident direct / diffuse
    fdir_net = []
    fdif_net = []
    for k in range(n + 1):
        refk = 1.0 / (1.0 - rdndif[k] * rupdif[k])
        fdirup = (trndir[k] * rupdir[k] +
                  (trntdr[k] - trndir[k]) * rupdif[k]) * refk
        fdirdn = trndir[k] + (trntdr[k] - trndir[k] +
                              trndir[k] * rupdir[k] * rdndif[k]) * refk
        fdifup = trndif[k] * rupdif[k] * refk
        fdifdn = trndif[k] * refk
        fdir_net.append(fdirdn - fdirup)
        fdif_net.append(fdifdn - fdifup)

    albdir = 1.0 - fdir_net[0]
    albdif = 1.0 - fdif_net[0]
    absdir = [fdir_net[k] - fdir_net[k + 1] for k in range(n)]
    absdif = [fdif_net[k] - fdif_net[k + 1] for k in range(n)]
    return albdir, albdif, absdir, absdif, fdir_net[n], fdif_net[n]


def _ice_layer_iops(hi, nilyr, ponded: bool, k_scale: float = 1.0,
                    tau_alg=None):
    """IOPs of the ice layers for all bands: a dedicated surface
    scattering layer (and, for bare ice, a drained layer) above nilyr
    uniform interior layers. Thin ice shrinks the surface classes to at
    most a third each. k_scale: R_ice/R_pnd extinction tuning of the
    surface classes; tau_alg: absorption optical depth of ice-algal
    chlorophyll added to the bottom layer in band 0 (visible) only."""
    if ponded:
        k_ssl = _bands([k * k_scale for k in K_PICE_SSL], hi)
        w_ssl = _bands(W_PICE_SSL, hi)
    else:
        k_ssl = _bands([k * k_scale for k in K_ICE_SSL], hi)
        w_ssl = _bands(W_ICE_SSL, hi)
        k_dl = _bands([k * k_scale for k in K_ICE_DL], hi)
        w_dl = _bands(W_ICE_DL, hi)
    k_int, w_int = _bands(K_ICE_INT, hi), _bands(W_ICE_INT, hi)

    h_ssl = torch.clamp(hi / 3.0, max=H_SSL)
    if ponded:
        h_int = torch.clamp(hi - h_ssl - 0.0, min=0.0)
    else:
        h_dl = torch.clamp(hi / 3.0, max=H_DL)
        h_int = torch.clamp(hi - h_ssl - h_dl, min=0.0)
    hl = h_int / nilyr

    ones = torch.ones_like(hi)
    g = G_ICE * ones
    out = [(h_ssl * k_ssl, w_ssl * ones, g)]
    if not ponded:
        out.append((h_dl * k_dl, w_dl * ones, g))
    for k in range(nilyr):
        tau = k_int * hl
        w0 = w_int * ones
        if tau_alg is not None and k == nilyr - 1:
            t2 = tau + torch.clamp(tau_alg, min=0.0)
            vis = _bands((1.0, 0.0, 0.0), hi) > 0.5
            w0 = torch.where(vis, w0 * tau / torch.clamp(t2, min=1e-12), w0)
            tau = torch.where(vis, t2, tau)
        out.append((tau, w0, g))
    return out


# Aerosol-in-snow optics per species class, [vis, nir] per property: the
# SNICAR coefficients of the Icepack kaer_tab/waer_tab/gaer_tab (species
# bc1, bc2, dust1..dust4; the nir entry serves both near-IR bands).
AER_OPTICS = [
    # (ext m2/kg (vis, nir), ssa (vis, nir), g (vis, nir))
    ((11580.0, 3687.0), (0.291, 0.174), (0.353, 0.287)),   # bc1 (fresh BC)
    ((25799.0, 8587.0), (0.744, 0.474), (0.598, 0.494)),   # bc2 (aged BC)
    ((196.5, 209.3), (0.972, 0.949), (0.673, 0.697)),      # dust1
    ((2665.9, 1538.5), (0.943, 0.897), (0.684, 0.668)),    # dust2
    ((840.8, 596.1), (0.946, 0.903), (0.716, 0.687)),      # dust3
    ((387.5, 276.0), (0.947, 0.906), (0.757, 0.712)),      # dust4
]
MODAL_BC_ENHANCE = 1.5   # internal-mixing absorption enhancement of BC
#                          (modal_aero; Flanner et al. 2012)


def _aerosol_bands(s: int, modal: bool):
    """(ext, ssa, g*ssa) of aerosol species s on the three bands as Python
    floats (vis in band 0, nir in bands 1-2); modal_aero enhances the
    absorption of the BC species and renormalises their ssa."""
    ext, ssa, ga = AER_OPTICS[s % len(AER_OPTICS)]
    out = []
    for bi in (0, 1, 1):
        ext_b, ssa_b, g_b = ext[bi], ssa[bi], ga[bi]
        if modal and s % len(AER_OPTICS) in (0, 1):
            abs_b = ext_b * (1.0 - ssa_b) * MODAL_BC_ENHANCE
            sca_b = ext_b * ssa_b
            ext_b = abs_b + sca_b
            ssa_b = sca_b / ext_b
        out.append((ext_b, ssa_b, g_b * ssa_b))
    return tuple(zip(*out))


def _mix_aerosol(tau, w0, g, aero_mass, modal: bool):
    """Blend aerosol extinction into a (tau, w0, g) layer on all bands.
    aero_mass: list over species of kg/m^2 loadings in the layer."""
    tau_t, sw_t, gsw_t = tau, w0 * tau, g * w0 * tau
    for s, mass in enumerate(aero_mass):
        ext_b, ssa_b, gssa_b = (_bands(v, mass)
                                for v in _aerosol_bands(s, modal))
        ta = ext_b * torch.clamp(mass, min=0.0)
        tau_t = tau_t + ta
        sw_t = sw_t + ssa_b * ta
        gsw_t = gsw_t + gssa_b * ta
    w0_t = sw_t / torch.clamp(tau_t, min=1e-12)
    g_t = gsw_t / torch.clamp(sw_t, min=1e-12)
    return tau_t, torch.clamp(w0_t, 0.0, 1.0), torch.clamp(g_t, 0.0, 1.0)


def _snow_iops(hs, nslyr, rsnw_m, aero_snow=None, modal: bool = False):
    """Snow layer IOPs: geometric-optics extinction tau = 3 h rho_s /
    (2 rho_i r) and the grain-radius single-scattering albedo fit;
    aerosol loadings darken the top (surface-scavenged) snow layer."""
    hl = hs / nslyr
    tau = 1.5 * hl * cst.rhos / (cst.rhoi * torch.clamp(rsnw_m, min=1e-5))
    w0 = torch.clamp(1.0 - _bands(W0_SNOW_COEF, hs) * torch.sqrt(rsnw_m),
                     0.3, 1.0)
    out = [(tau, w0 * torch.ones_like(hs), torch.full_like(hs, G_SNOW))
           for _ in range(nslyr)]
    if aero_snow is not None and len(aero_snow):
        out[0] = _mix_aerosol(*out[0], aero_snow, modal)
    return out


def _column(mu0, *, hs, hi, hpnd, nslyr, nilyr, rsnw_m, kind,
            R_ice=0.0, R_pnd=0.0, aero_snow=None, modal=False,
            tau_alg=None):
    """Albedos and absorption of one sub-column kind ('snow'|'bare'|'pond')
    for all bands (each result has the bands on its leading dimension)."""
    ponded = kind == "pond"
    k_scale = 1.0
    if R_ice and not ponded:
        k_scale = max(1.0 + 0.15 * R_ice, 0.05)
    if R_pnd and ponded:
        k_scale = max(1.0 + 0.15 * R_pnd, 0.05)
    layers = []
    nsl = 0
    if kind == "snow":
        layers += _snow_iops(hs, nslyr, rsnw_m, aero_snow, modal)
        nsl = nslyr
    elif ponded:
        # pond water: a pure absorber
        layers.append((_bands(K_POND_W, hpnd) * hpnd, torch.zeros_like(hpnd),
                       torch.zeros_like(hpnd)))
        nsl = 1
    ice_layers = _ice_layer_iops(hi, nilyr, ponded, k_scale=k_scale,
                                 tau_alg=tau_alg)
    n_srf_ice = len(ice_layers) - nilyr    # the dedicated SSL (+DL)
    layers += ice_layers
    albdir, albdif, absdir, absdif, trdir, trdif = _adding(
        layers, mu0, ALB_OCEAN)
    # absorption above the ice is surface absorption; the SSL/DL
    # absorption joins the top thermo layer
    zero = torch.zeros_like(albdir)
    sfc_dir = sum(absdir[:nsl]) if nsl else zero
    sfc_dif = sum(absdif[:nsl]) if nsl else zero
    ice_dir = list(absdir[nsl + n_srf_ice:])
    ice_dif = list(absdif[nsl + n_srf_ice:])
    ice_dir[0] = ice_dir[0] + sum(absdir[nsl:nsl + n_srf_ice])
    ice_dif[0] = ice_dif[0] + sum(absdif[nsl:nsl + n_srf_ice])
    return dict(albdir=albdir, albdif=albdif,
                sfc_dir=sfc_dir, sfc_dif=sfc_dif,
                ice_dir=ice_dir, ice_dif=ice_dif,
                tr_dir=trdir, tr_dif=trdif)


def shortwave_dEdd(Tsf, hi, hs, hpnd, apeff, swvdr, swvdf, swidr, swidf,
                   coszen, cfg_sw, nilyr: int, nslyr: int = 1,
                   aero_snow=None, modal_aero: bool = False,
                   tau_alg=None) -> ShortwaveOut:
    """Delta-Eddington shortwave for all categories at once.

    Tsf/hi/hs/hpnd/apeff: (ncat, ny, nx); sw* and coszen (ny, nx).
    Sub-column area weights per category: ponded = apeff, snow-covered
    = (1-apeff)*fsnow_patch, bare = the remainder. aero_snow: optional
    list over species of (ncat, ny, nx) kg/m^2 snow aerosol loadings
    (tr_aero; modal_aero enhances BC absorption); tau_alg: optional (ncat,
    ny, nx) ice-algal absorption optical depth (zbgc dEdd_algae)."""
    mu0 = torch.clamp(coszen, min=MU0_MIN) * torch.ones_like(Tsf)
    hi_s = torch.clamp(hi, min=0.0)
    hs_s = torch.clamp(hs, min=0.0)

    # snow grain radius (m): from cold fine grains to the melting radius
    # rsnw_mlt over dT_mlt (R_snw shifts the melting-onset radius)
    dTs = torch.clamp((cst.Timelt - Tsf) / cfg_sw.dT_mlt, 0.0, 1.0)
    rsnw_um = cfg_sw.rsnw_mlt - (cfg_sw.rsnw_mlt - 180.0) * dTs \
        - 30.0 * cfg_sw.R_snw
    rsnw_m = torch.clamp(rsnw_um, 50.0, 2000.0) * 1e-6

    fsnow_patch = hs_s / (hs_s + cst.snowpatch)
    w_pnd = torch.clamp(apeff, 0.0, 1.0)
    w_snw = (1.0 - w_pnd) * fsnow_patch
    w_bare = torch.clamp(1.0 - w_pnd - w_snw, min=0.0)

    common = dict(hs=hs_s, hi=torch.clamp(hi_s, min=0.001), hpnd=hpnd,
                  nslyr=nslyr, nilyr=nilyr, rsnw_m=rsnw_m,
                  R_ice=cfg_sw.R_ice, R_pnd=cfg_sw.R_pnd,
                  aero_snow=aero_snow, modal=modal_aero, tau_alg=tau_alg)
    cols = {k: _column(mu0, kind=k, **common)
            for k in ("snow", "bare", "pond")}

    def mix(get):
        return (w_snw * get(cols["snow"]) + w_bare * get(cols["bare"]) +
                w_pnd * get(cols["pond"]))

    out = {key: mix(lambda c, key=key: c[key])
           for key in ("albdir", "albdif", "sfc_dir", "sfc_dif", "tr_dir",
                       "tr_dif")}
    for key in ("ice_dir", "ice_dif"):
        out[key] = [mix(lambda c, key=key, k=k: c[key][k])
                    for k in range(nilyr)]

    # per-band incident fluxes: band 0 = the visible stream; the near-IR
    # stream splits onto bands 1-2 with the published weights
    inc_dr = (swvdr, swidr * W_NIR[0], swidr * W_NIR[1])
    inc_df = (swvdf, swidf * W_NIR[0], swidf * W_NIR[1])

    def tot3(dr, df):
        return sum(inc_dr[b] * dr[b] + inc_df[b] * df[b]
                   for b in range(NBAND))

    sfc = tot3(out["sfc_dir"], out["sfc_dif"])
    layer_abs = [tot3(out["ice_dir"][k], out["ice_dif"][k])
                 for k in range(nilyr)]
    fswthru = tot3(out["tr_dir"], out["tr_dif"])
    fswint = sum(layer_abs)
    # reported near-IR albedos: incident-weighted mean of the two sub-bands
    alid = {d: W_NIR[0] * out[d][1] + W_NIR[1] * out[d][2]
            for d in ("albdir", "albdif")}

    dark = (swvdr + swvdf + swidr + swidf) <= cst.puny

    def zero_sun(x):
        return torch.where(dark, 0.0, x)

    Iswabs = torch.stack([zero_sun(a) for a in layer_abs], dim=1)
    return ShortwaveOut(
        alvdr=torch.clamp(out["albdir"][0], 0.0, 1.0),
        alvdf=torch.clamp(out["albdif"][0], 0.0, 1.0),
        alidr=torch.clamp(alid["albdir"], 0.0, 1.0),
        alidf=torch.clamp(alid["albdif"], 0.0, 1.0),
        fswsfc=zero_sun(sfc), fswint=zero_sun(fswint),
        fswthru=zero_sun(fswthru), Iswabs=Iswabs,
        fswpen=zero_sun(fswint + fswthru))
