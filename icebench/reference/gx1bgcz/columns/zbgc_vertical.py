"""Vertically resolved biogeochemistry on the brine column (z_tracers /
solve_zbgc; a frozen copy of the program's columns/zbgc_vertical.py
with its subtraction-free transport solve, a PyTorch port of
cice_tpu/columns/zbgc_vertical.py; reference
icepack_biogeochemistry, ice_step_mod.F90:1634-1782, zbgc_nml in
ug_case_settings.rst:802-960).

Each z tracer lives on `nblyr` equal bio layers spanning the brine column
`hbr = fbri*hin` (Jeffery, Hunke & Elliott 2011; Jeffery & Hunke 2014),
split into a mobile phase that moves with the brine and a stationary phase
attached to the ice; the mobile phase is carried by an implicit upwind
advection-diffusion solve with ocean exchange at the bottom and snow or
atmospheric sources at the top, and `solve_zbgc` runs the ecosystem network
of the skeletal model per layer.

The port stacks the z tracers on one leading dimension for the snow
reservoirs, the mobile/stationary exchange, the transport and the Thomas
solve: the tridiagonal coefficients are the same for every tracer, so the
elimination factors are computed once and the right-hand sides of all
tracers sweep together. Each element sees the JAX package's operations in
its order, but for the Thomas solve, which the port carries
subtraction-free (`tridiag_solve`): on a thin brine column the JAX
package's direct form cancels its pivot to zero in float32 and overflows.
The thin-brine-column rule of `step_zbgc` is the port's own too. The
reaction network keeps its loops over algal classes.

Layout: every z tracer is (ncat, nblyr, ny, nx); a stack is (nz, ncat,
nblyr, ny, nx) in `z_tracer_names` order.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import numpy as np
import torch

from ...ice import constants as cst
from ...ice.ops import lsum, rdiv
from .mushy import liquid_fraction, temperature_mush

# percolation threshold for brine connectivity (Golden et al. 2007)
PHI_C = 0.05
# molecular diffusivity of solutes in brine (m^2/s)
D_MOLECULAR = 1.0e-9
# gravity-drainage eddy enhancement of a draining column (m^2/s)
D_DRAINAGE = 5.0e-6
# PAR fraction of shortwave penetrating the ice interior
FRAC_PAR = 0.45
# ice attenuation for PAR (1/m)
KAPPA_ICE = 1.4
# minimum snow depth holding a bio snow reservoir (m)
HS_BIO_MIN = 0.01
# minimum brine height holding z tracers of its own (m): the thin-brine-
# column rule of `step_zbgc`, at the snow reservoirs' depth
HBR_BIO_MIN = 0.01

# mixed-layer defaults of the dissolved tracers (zbgc config attributes)
_DISSOLVED_OCEAN_ATTRS = {
    "bgc_Nit": "nit_data", "bgc_Am": "amm_data", "bgc_Sil": "sil_data",
    "bgc_DMSPd": "dms_data", "bgc_DMS": "dms_data", "bgc_DON": "don_data",
    "bgc_Fed": "fed_data", "bgc_Fed2": "fed_data", "bgc_hum": "hum_data",
}

ALGAE = ("bgc_N", "bgc_N2", "bgc_N3")   # diatoms, small plankton, Phaeocystis


def z_tracer_names(zcfg) -> list[str]:
    """Active z-tracer names in registry order (init_zbgc)."""
    names: list[str] = []
    if zcfg.tr_bgc_N:
        names += list(ALGAE[: zcfg.n_algae])
    if zcfg.tr_bgc_Nit:
        names.append("bgc_Nit")
    if zcfg.tr_bgc_Am:
        names.append("bgc_Am")
    if zcfg.tr_bgc_Sil:
        names.append("bgc_Sil")
    if zcfg.tr_bgc_DMS:
        names += ["bgc_DMSPp", "bgc_DMSPd", "bgc_DMS"]
    if zcfg.tr_bgc_PON:
        names.append("bgc_PON")
    if zcfg.tr_bgc_DON:
        names.append("bgc_DON")
    if zcfg.tr_bgc_C:
        names += [f"bgc_DOC{i+1}" for i in range(zcfg.n_doc)]
        names += [f"bgc_DIC{i+1}" for i in range(zcfg.n_dic)]
    if zcfg.tr_bgc_Fe:
        # up to two dissolved and two particulate classes; class 1 keeps
        # the bare name, class 2 appends "2"
        names += ["bgc_Fed"] + [f"bgc_Fed{i+1}"
                                for i in range(1, min(zcfg.n_fed, 2))]
        names += ["bgc_Fep"] + [f"bgc_Fep{i+1}"
                                for i in range(1, min(zcfg.n_fep, 2))]
    if zcfg.tr_bgc_hum:
        names.append("bgc_hum")
    if zcfg.tr_zaero:
        names += [f"zaero{i+1}" for i in range(zcfg.n_zaero)]
    return names


def mobility_type(zcfg, name: str) -> float:
    """Per-tracer mobility type (the zbgc_nml *type* parameters)."""
    if name in ALGAE:
        types = (zcfg.algaltype_diatoms, zcfg.algaltype_sp,
                 zcfg.algaltype_phaeo)
        return types[ALGAE.index(name)]
    table = {
        "bgc_Nit": zcfg.nitratetype, "bgc_Am": zcfg.ammoniumtype,
        "bgc_Sil": zcfg.silicatetype, "bgc_DMSPp": zcfg.dmspptype,
        "bgc_DMSPd": zcfg.dmspdtype, "bgc_DMS": zcfg.dmspdtype,
        "bgc_DON": zcfg.dontype_protein, "bgc_PON": zcfg.nitratetype,
        "bgc_Fed": zcfg.fedtype_1, "bgc_Fep": zcfg.feptype_1,
        "bgc_Fed2": zcfg.fedtype_1, "bgc_Fep2": zcfg.feptype_1,
        "bgc_hum": zcfg.humtype,
    }
    if name.startswith("zaero"):
        idx = int(name[5:]) - 1
        za = (zcfg.zaerotype_bc1, zcfg.zaerotype_bc2, zcfg.zaerotype_dust1,
              zcfg.zaerotype_dust2, zcfg.zaerotype_dust3,
              zcfg.zaerotype_dust4)
        return za[min(idx, len(za) - 1)]
    if name.startswith("bgc_DOC"):
        dtypes = (zcfg.doctype_s, zcfg.doctype_l, zcfg.doctype_s)
        return dtypes[min(int(name[7:]) - 1, 2)]
    if name.startswith("bgc_DIC"):
        return zcfg.dictype_1
    return table.get(name, 0.0)


def ocean_concentration(zcfg, name: str) -> float:
    """Mixed-layer default of a dissolved tracer (ice_forcing_bgc)."""
    if name.startswith("bgc_DOC"):
        return float(zcfg.doc_data)
    if name.startswith("bgc_DIC"):
        return float(zcfg.dic_data)
    attr = _DISSOLVED_OCEAN_ATTRS.get(name)
    return float(getattr(zcfg, attr)) if attr else 0.0


@functools.lru_cache(maxsize=64)
def _column_table(values, dtype, device):
    """Per-tracer Python constants as an (nz, 1, 1, 1, 1) tensor, each
    rounded once to `dtype` as a weakly typed JAX scalar is. Uploaded once
    per (values, dtype, device)."""
    return torch.as_tensor(np.asarray(values, np.float64), dtype=dtype,
                           device=device).reshape(-1, 1, 1, 1, 1)


# ---------------------------------------------------------------------------
# vertical grid and porosity
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _interp_matrix(nblyr, nilyr, dtype, device):
    """(nblyr, nilyr) hat weights from the ice-layer midpoints onto the
    bio-layer midpoints. Built in float64 and rounded to `dtype`, as the
    JAX package builds it with x64 on."""
    zb = (np.arange(nblyr) + 0.5) / nblyr
    zi = (np.arange(nilyr) + 0.5) / nilyr
    idx = np.clip(np.searchsorted(zi, zb) - 1, 0, nilyr - 2)
    w1 = np.clip((zb - zi[idx]) * nilyr, 0.0, 1.0)
    W = np.zeros((nblyr, nilyr))
    W[np.arange(nblyr), idx] = 1.0 - w1
    W[np.arange(nblyr), idx + 1] += w1
    return torch.as_tensor(W, dtype=dtype, device=device)


def porosity_profile(qice, sice, nblyr):
    """Brine porosity (liquid fraction) on the bio grid, (ncat, nb, ny,
    nx): the mushy liquid fraction of the nilyr ice layers interpolated
    onto nblyr equal bio layers."""
    nilyr = qice.shape[1]
    Sk = torch.clamp(sice, min=cst.puny)
    Tk = temperature_mush(qice, Sk)
    phi = torch.clamp(liquid_fraction(torch.clamp(Tk, max=-cst.puny), Sk),
                      0.0, 1.0)
    W = _interp_matrix(nblyr, nilyr, phi.dtype, phi.device)
    phi_b = torch.einsum("bl,clyx->cbyx", W, phi)
    return torch.clamp(phi_b, 0.0, 1.0)


def par_profile(fswthru_top, chl_abs, hbr, nblyr, zcfg):
    """PAR at the bio-layer midpoints from the SW entering the ice
    interior, attenuated by ice and self-shading chlorophyll (chl_abs: the
    absorption-weighted chlorophyll sum, (ncat, nb, ny, nx) or 0)."""
    del zcfg
    dz = torch.clamp(hbr, min=cst.puny)[:, None] / nblyr
    z_mid = (torch.arange(nblyr, dtype=fswthru_top.dtype,
                          device=fswthru_top.device)[None, :, None, None]
             + 0.5) * dz
    kappa = KAPPA_ICE + chl_abs
    return FRAC_PAR * torch.clamp(fswthru_top, min=0.0)[:, None] * \
        torch.exp(-kappa * z_mid)


# ---------------------------------------------------------------------------
# tridiagonal (Thomas) solve
# ---------------------------------------------------------------------------

def tridiag_solve(lower, upper, excess, rhs):
    """Solve the transport's tridiagonal systems along the layer axis.

    lower, upper (ncat, nb, ny, nx) are the couplings (<= 0; lower[:, 0]
    and upper[:, -1] unused) and excess (ncat, nb, ny, nx) each column's
    excess (> 0): the diagonal is excess_k + |upper_{k-1}| + |lower_{k+1}|,
    the form of an implicit conservative transport, whose column k loses
    to its neighbours what they gain and keeps excess_k (the unit storage
    term, plus the exchange with the ocean in the bottom layer). rhs is
    (..., ncat, nb, ny, nx) with any leading stack dimensions, which share
    the coefficients; the elimination factors are computed once.

    This is the Thomas elimination carried subtraction-free (Grassmann,
    Taksar & Heyman 1985, Oper. Res. 33:1107, for M-matrices): the pivot
    d_k = diag_k - lower_k upper_{k-1} / d_{k-1} is kept as f_k +
    |lower_{k+1}| with f_k = excess_k + |upper_{k-1}| f_{k-1} / d_{k-1},
    and the sweeps add positive terms only. The system and its solution
    are those of the direct form; where a brine column is thin the
    couplings dt D / dz^2 reach 1e20 (dz at `puny`), and the direct form
    computes its pivot as a difference of such numbers: it cancels in
    float32, and where it cancels to zero the division by its 1e-30
    guard leaves float32's range. Here every pivot is at least its
    excess."""
    nb = excess.shape[1]
    a = [-lower[:, k] for k in range(nb)]
    b = [-upper[:, k] for k in range(nb)]
    r = [rhs.select(-3, k) for k in range(nb)]
    den = [None] * nb
    dp = [None] * nb
    f = excess[:, 0]
    for k in range(nb):
        if k:
            f = excess[:, k] + b[k - 1] * (f / den[k - 1])
        den[k] = f + a[k + 1] if k < nb - 1 else f
        dp[k] = (r[k] + a[k] * dp[k - 1] if k else r[k]) / den[k]
    x = [None] * nb
    x[nb - 1] = dp[nb - 1]
    for k in range(nb - 2, -1, -1):
        x[k] = dp[k] + (b[k] / den[k]) * x[k + 1]
    return torch.stack(x, dim=-3)


# ---------------------------------------------------------------------------
# ecosystem reaction network, per layer (solve_zbgc)
# ---------------------------------------------------------------------------

def _per_class(zcfg, attr3):
    return tuple(float(getattr(zcfg, a)) for a in attr3)


def _max0(x):
    return torch.clamp(x, min=0.0) if isinstance(x, torch.Tensor) \
        else max(x, 0.0)


def algal_network(zcfg, dt, trc: Dict[str, torch.Tensor], PAR, T_layer):
    """One reaction step on bulk concentrations (mmol/m^3 of brine
    column), all (ncat, nb, ny, nx). Returns (updated dict, the summed
    specific growth, {'upNO', 'upNH'} uptake rates). Jin et al. 2006
    limitation forms with per-class parameters; Elliott et al. 2012 sulfur
    chain; nitrification, bacterial DON/DOC degradation, iron scavenging
    and desorption."""
    out = dict(trc)
    secday = cst.secday
    mu_max = _per_class(zcfg, ("mu_max_diatoms", "mu_max_sp", "mu_max_phaeo"))
    gTdep = _per_class(zcfg, ("grow_Tdep_diatoms", "grow_Tdep_sp",
                              "grow_Tdep_phaeo"))
    mort0 = _per_class(zcfg, ("mort_pre_diatoms", "mort_pre_sp",
                              "mort_pre_phaeo"))
    mTdep = _per_class(zcfg, ("mort_Tdep_diatoms", "mort_Tdep_sp",
                              "mort_Tdep_phaeo"))
    K_Nit = _per_class(zcfg, ("K_Nit_diatoms", "K_Nit_sp", "K_Nit_phaeo"))
    K_Am = _per_class(zcfg, ("K_Am_diatoms", "K_Am_sp", "K_Am_phaeo"))
    K_Sil = _per_class(zcfg, ("K_Sil_diatoms", "K_Sil_sp", "K_Sil_phaeo"))
    alpha = _per_class(zcfg, ("alpha2max_low_diatoms", "alpha2max_low_sp",
                              "alpha2max_low_phaeo"))
    beta = _per_class(zcfg, ("beta2max_diatoms", "beta2max_sp",
                             "beta2max_phaeo"))
    R_Si2N = _per_class(zcfg, ("ratio_Si2N_diatoms", "ratio_Si2N_sp",
                               "ratio_Si2N_phaeo"))
    R_S2N = _per_class(zcfg, ("ratio_S2N_diatoms", "ratio_S2N_sp",
                              "ratio_S2N_phaeo"))
    fr_graze = _per_class(zcfg, ("fr_graze_diatoms", "fr_graze_sp",
                                 "fr_graze_phaeo"))

    Nit = trc.get("bgc_Nit")
    Am = trc.get("bgc_Am")
    Sil = trc.get("bgc_Sil")

    tot_upNit = 0.0
    tot_upAm = 0.0
    tot_upSil = 0.0
    tot_graze = 0.0          # grazed N
    tot_mort = 0.0           # mortality N
    grow_net = None

    for ia, name in enumerate(ALGAE):
        if name not in trc:
            continue
        Nalg = trc[name]
        # light limitation with photoinhibition
        L_lim = (1.0 - torch.exp(-alpha[ia] * PAR)) * torch.exp(-beta[ia] * PAR)
        N_pool = Nit if Nit is not None else torch.full_like(Nalg,
                                                             zcfg.nit_data)
        N_lim = N_pool / (N_pool + K_Nit[ia])
        if Am is not None:
            N_lim = torch.maximum(N_lim, Am / (Am + K_Am[ia]))
        lim = torch.minimum(L_lim, N_lim)
        if R_Si2N[ia] > 0.0 and Sil is not None:
            lim = torch.minimum(lim, Sil / (Sil + K_Sil[ia]))
        mu = mu_max[ia] / secday * torch.exp(gTdep[ia] * T_layer) * lim
        grow = mu * Nalg * dt
        # uptake is held to max_loss of the available nutrient pool
        avail = N_pool + (Am if Am is not None else 0.0)
        grow = torch.minimum(grow, zcfg.max_loss * torch.clamp(avail,
                                                               min=0.0))
        if Am is not None:
            upAm = torch.minimum(grow, zcfg.max_loss *
                                 torch.clamp(Am, min=0.0))
        else:
            upAm = torch.zeros_like(grow)
        upNit = grow - upAm
        mort = (mort0[ia] / secday * torch.exp(mTdep[ia] * T_layer)
                * Nalg * dt)
        graze = fr_graze[ia] / secday * Nalg * dt
        loss = torch.minimum(mort + graze, Nalg + grow)
        out[name] = torch.clamp(Nalg + grow - loss, min=0.0)
        tot_graze = tot_graze + loss * (
            graze / torch.clamp(mort + graze, min=1e-30))
        tot_mort = tot_mort + loss * (
            mort / torch.clamp(mort + graze, min=1e-30))
        tot_upNit = tot_upNit + upNit
        tot_upAm = tot_upAm + upAm
        tot_upSil = tot_upSil + R_Si2N[ia] * grow
        grow_net = mu if grow_net is None else grow_net + mu
        if "bgc_DMSPp" in trc:
            out["bgc_DMSPp"] = out["bgc_DMSPp"] + R_S2N[ia] * (grow - loss)

    # partition of the losses (zbgc_nml fractionation parameters)
    graze_spill = zcfg.fr_graze_s * tot_graze
    graze_excrete = (1.0 - zcfg.fr_graze_s) * zcfg.fr_graze_e * tot_graze
    mort_to_Am = zcfg.fr_mort2min * tot_mort
    mort_to_pools = (1.0 - zcfg.fr_mort2min) * tot_mort

    if Am is not None:
        nitrif = zcfg.k_nitrif / secday * torch.clamp(Am, min=0.0) * dt
        out["bgc_Am"] = torch.clamp(
            Am + mort_to_Am + graze_excrete - tot_upAm - nitrif, min=0.0)
    else:
        nitrif = mort_to_Am + graze_excrete
    if Nit is not None:
        out["bgc_Nit"] = _max0(Nit + nitrif - tot_upNit)
    if Sil is not None:
        out["bgc_Sil"] = _max0(Sil - tot_upSil)

    don_remin = 0.0
    if "bgc_DON" in trc:
        don_src = zcfg.f_don_protein * graze_spill
        kn = zcfg.kn_bac_protein / secday * dt
        don_remin = kn * torch.clamp(trc["bgc_DON"], min=0.0)
        out["bgc_DON"] = _max0(trc["bgc_DON"] + don_src - don_remin)
        if "bgc_Am" in out and Am is not None:
            out["bgc_Am"] = out["bgc_Am"] + zcfg.f_don_Am_protein * don_remin

    # carbon: algal growth fixes DIC, spilled losses feed the DOC pools,
    # bacterial degradation respires DOC back to DIC
    if "bgc_DOC1" in trc:
        R_C2N = _per_class(zcfg, ("ratio_C2N_diatoms", "ratio_C2N_sp",
                                  "ratio_C2N_phaeo"))
        c_spill = R_C2N[0] * (graze_spill + mort_to_pools) \
            + zcfg.ratio_C2N_proteins * (don_remin if "bgc_DON" in trc
                                         else 0.0)
        f_doc = (zcfg.f_doc_s, zcfg.f_doc_l, max(
            1.0 - zcfg.f_doc_s - zcfg.f_doc_l, 0.0))
        kn_doc = (zcfg.kn_bac_s, zcfg.kn_bac_l, zcfg.kn_bac_s)
        doc_resp = 0.0
        for i in range(3):
            nm = f"bgc_DOC{i+1}"
            if nm not in trc:
                continue
            remin = kn_doc[i] / secday * dt * torch.clamp(trc[nm], min=0.0)
            out[nm] = _max0(trc[nm] + f_doc[i] * c_spill - remin)
            doc_resp = doc_resp + zcfg.fr_resp_s * remin
        if "bgc_DIC1" in trc:
            # photosynthetic DIC drawdown by the realised N growth
            c_fix = R_C2N[0] * (tot_upNit + tot_upAm)
            DIC = torch.clamp(trc["bgc_DIC1"], min=0.0)
            out["bgc_DIC1"] = _max0(DIC + doc_resp - c_fix)
    if "bgc_PON" in trc:
        pon_src = mort_to_pools + (1.0 - zcfg.f_don_protein) * graze_spill
        out["bgc_PON"] = _max0(trc["bgc_PON"] + pon_src)

    if "bgc_DMSPp" in trc and "bgc_DMSPd" in trc:
        DMSPp = torch.clamp(out["bgc_DMSPp"], min=0.0)
        lysis = dt / (zcfg.t_sk_conv * secday) * DMSPp
        out["bgc_DMSPp"] = DMSPp - lysis
        conv = dt / (zcfg.t_sk_conv * secday) * torch.clamp(
            trc["bgc_DMSPd"], min=0.0)
        out["bgc_DMSPd"] = torch.clamp(trc["bgc_DMSPd"] + lysis - conv,
                                       min=0.0)
        if "bgc_DMS" in trc:
            ox = dt / (zcfg.t_sk_ox * secday) * torch.clamp(
                trc["bgc_DMS"], min=0.0)
            out["bgc_DMS"] = torch.clamp(
                trc["bgc_DMS"] + zcfg.y_sk_DMS * conv - ox, min=0.0)

    # iron classes pair dissolved_i <-> particulate_i: scavenging onto
    # particles and slow desorption back (t_iron_conv)
    for dkey, pkey in (("bgc_Fed", "bgc_Fep"), ("bgc_Fed2", "bgc_Fep2")):
        if dkey not in trc:
            continue
        Fed = torch.clamp(trc[dkey], min=0.0)
        scav = zcfg.k_fe_scav / secday * Fed * dt
        out[dkey] = Fed - scav
        if pkey in trc:
            Fep = torch.clamp(trc[pkey], min=0.0)
            desorb = dt / (zcfg.t_iron_conv * secday) * Fep
            out[pkey] = torch.clamp(Fep + scav - desorb, min=0.0)
            out[dkey] = out[dkey] + desorb

    # humics and zaero are passive (transport only)
    if grow_net is None:
        grow_net = torch.zeros_like(PAR)
    diags = {"upNO": tot_upNit / dt, "upNH": tot_upAm / dt}
    return out, grow_net, diags


# ---------------------------------------------------------------------------
# the full z-tracer step
# ---------------------------------------------------------------------------

class ZbgcOut(NamedTuple):
    trc: Dict[str, torch.Tensor]      # updated z tracers (ncat, nb, ny, nx)
    frac: Dict[str, torch.Tensor]     # updated mobile fractions
    flux_ocn: Dict[str, torch.Tensor]  # name -> net flux to ocean
    grow_net: torch.Tensor            # cell-mean net specific growth (1/s)
    chl_int: torch.Tensor             # integrated chlorophyll (mg/m^2)
    # interior-state history profiles (bTizn/bphizn/zfswin/iDin/ikin,
    # area-weighted category sums on the bio grid) and upNO/upNH/PP_net
    diags: Dict[str, torch.Tensor]
    # updated snow reservoirs (name -> (ncat, ny, nx) per-category-area
    # content)
    snow: Dict[str, torch.Tensor]


def step_zbgc(zcfg, dt, *, aicen, vicen, vsnon, fbri, qice, sice,
              trc: Dict[str, torch.Tensor], frac: Dict[str, torch.Tensor],
              darcy_V, fswthru, Tbot, meltt, meltb, congel, frazil,
              zaero_dep: Dict[str, torch.Tensor] | None = None,
              ocean: Dict[str, torch.Tensor] | None = None,
              snow: Dict[str, torch.Tensor] | None = None,
              melts=None):
    """Advance all z tracers one coupled transport, exchange and reaction
    step. aicen/vicen/vsnon/fbri/darcy_V/Tbot/meltt/meltb/congel: (ncat,
    ny, nx) or broadcastable; qice/sice: (ncat, nilyr, ny, nx); fswthru: SW
    entering the interior; frazil: (ny, nx) new frazil volume this step;
    zaero_dep: name -> deposition rate broadcastable to (ny, nx); ocean:
    name -> mixed-layer concentration overriding the defaults; snow: the
    per-tracer snow reservoirs (per-category-area content), for every
    tracer or none: deposition lands there while snow is present, and snow
    melt `melts` flushes the melted share into the top bio layer.

    The thin-brine-column rule: a category with ice whose brine column is
    under HBR_BIO_MIN (1 cm; a category whose ice melted through in this
    step has none) is not solved. Its brine is in free exchange with the
    ocean: its z tracers take the mixed layer's concentrations (those of
    the transport's bottom boundary: the dissolved tracers' mixed-layer
    values, zero for algae and particulates), and what it held above them
    and what its snow reservoirs release in this step go to the ocean's
    flux. Without the rule such a column's concentrations are its
    contents over a height near zero, and grow without bound (1e10-1e14
    mmol/m^3 in gx1 runs of a few hundred hourly steps) where the column
    lingers at a vanishing area."""
    names = list(trc.keys())
    if snow and set(names) - set(snow):
        raise ValueError("step_zbgc: snow reservoirs must be given for "
                         "every z tracer or for none")
    nz = len(names)
    dtype, dev = aicen.dtype, aicen.device
    nb = trc[names[0]].shape[1]
    Tbot = torch.broadcast_to(Tbot, aicen.shape)
    fswthru = torch.broadcast_to(fswthru, aicen.shape)
    mask = aicen > cst.puny
    am = torch.clamp(aicen, min=cst.puny)
    hin = torch.where(mask, vicen / am, 0.0)
    hbr = torch.clamp(fbri, 0.0, 1.2) * hin
    dz = torch.clamp(hbr, min=cst.puny) / nb                # (ncat, ny, nx)
    dzb = dz[:, None]
    # the columns that hold z tracers of their own; the thin-brine-column
    # rule replaces the rest below
    held = mask & (hbr >= HBR_BIO_MIN)
    thin = mask & ~held

    # --- snow reservoirs: per-category-area contents; deposition lands
    # there while snow is present, snow melt flushes the melted-volume
    # share into the top bio layer and a vanished snowpack the remainder.
    # Every amount leaving a reservoir enters layer 0.
    hs = torch.where(mask, vsnon / am, 0.0)
    snow_present = hs > HS_BIO_MIN
    deps = {} if zaero_dep is None else {n: zaero_dep[n] for n in names
                                         if n in zaero_dep}
    dep_amt = None
    if deps:
        zero2 = aicen.new_zeros(aicen.shape[1:])
        dep_amt = torch.stack([torch.broadcast_to(deps.get(n, zero2),
                                                  aicen.shape[1:])
                               for n in names])[:, None] * dt
    snow_new: Dict[str, torch.Tensor] = {}
    top_amount = None                          # (nz, ncat, ny, nx)
    if snow:
        melts_c = (torch.broadcast_to(melts, aicen.shape)
                   if melts is not None else torch.zeros_like(aicen))
        mpos = torch.clamp(melts_c, min=0.0)
        melt_frac = torch.clamp(mpos / torch.clamp(hs + mpos, min=cst.puny),
                                0.0, 1.0)
        R = torch.stack([snow[n] for n in names])
        melt_flush = torch.where(mask, R * melt_frac, 0.0)
        R = R - melt_flush
        resid_flush = torch.where(mask & ~snow_present, R, 0.0)
        R = torch.where(snow_present, R, 0.0)
        top_amount = melt_flush + resid_flush
        if dep_amt is not None:
            R = R + torch.where(mask & snow_present, dep_amt, 0.0)
            top_amount = top_amount + torch.where(mask & ~snow_present,
                                                  dep_amt, 0.0)
        R = torch.where(mask, R, 0.0)
        snow_new = {n: R[i] for i, n in enumerate(names)}
    elif dep_amt is not None:
        top_amount = torch.where(mask, dep_amt, 0.0)

    phi = porosity_profile(qice, sice, nb)
    phi = torch.clamp(phi, min=0.02)
    phi_min = torch.amin(phi, dim=1)

    # --- velocities and diffusivity on the bio grid: downward-positive
    # mobile-phase velocity = Darcy drainage (darcy_V > 0 floods upward)
    # plus meltwater flushing through a permeable column
    permeable = (phi_min > PHI_C).to(dtype)
    flush = permeable * (cst.rhoi / cst.rhow) * torch.clamp(meltt, min=0.0) \
        / dt
    w_down = -darcy_V + flush                               # (ncat, ny, nx)
    w = torch.broadcast_to(w_down[:, None], phi.shape)
    D = torch.broadcast_to(
        D_MOLECULAR + D_DRAINAGE * permeable[:, None] * torch.clamp(
            torch.abs(darcy_V)[:, None] / 1e-7, 0.0, 1.0), phi.shape)

    # --- per-layer temperature for the reaction rates
    zmid = (torch.arange(nb, dtype=dtype, device=dev)[None, :, None, None]
            + 0.5) / nb
    Tsf_proxy = torch.clamp(Tbot, max=0.0)
    T_layer = torch.broadcast_to(Tsf_proxy[:, None], phi.shape) * (
        1.0 - 0.3 * (1.0 - zmid))

    # --- light and reactions
    chl_tot = 0.0
    chl_abs = 0.0     # absorption-weighted (per-class chlabs_*)
    for ia, aname in enumerate(ALGAE):
        if aname in trc:
            r = (zcfg.ratio_chl2N_diatoms, zcfg.ratio_chl2N_sp,
                 zcfg.ratio_chl2N_phaeo)[ia]
            ka = (zcfg.chlabs_diatoms, zcfg.chlabs_sp, zcfg.chlabs_phaeo)[ia]
            chl_c = r * torch.clamp(trc[aname], min=0.0)
            chl_tot = chl_tot + chl_c
            chl_abs = chl_abs + ka * chl_c
    PAR = par_profile(fswthru, chl_abs, hbr, nb, zcfg)
    zero2 = torch.zeros(aicen.shape[1:], dtype=dtype, device=dev)
    if zcfg.solve_zbgc:
        trc, grow_net_l, net_diags = algal_network(zcfg, dt, trc, PAR,
                                                   T_layer)
        grow_net = lsum(lsum(
            torch.where(mask[:, None], aicen[:, None] * grow_net_l, 0.0),
            1)) / nb

        # column-integrated uptake rates (mmol N/m^2/s): a layer rate is
        # per brine volume; integrate x dz over the column, area-weight
        def colint(rate):
            if not isinstance(rate, torch.Tensor):
                return zero2
            return lsum(lsum(torch.where(mask[:, None], rate * dzb, 0.0)
                             * aicen[:, None], 1))
        upNO = colint(net_diags["upNO"])
        upNH = colint(net_diags["upNH"])
        # net primary production (mg C/m^2/d): realised N uptake x C:N x
        # 12 g C/mol
        PP_net = (upNO + upNH) * float(zcfg.ratio_C2N_diatoms) * 12.0 \
            * cst.secday
    else:
        grow_net = upNO = upNH = PP_net = zero2

    # --- mobile <-> stationary exchange, all tracers at once
    growing = ((congel + frazil[None]) > 0.0) | (darcy_V > 0.0)
    melting = meltb + meltt > 0.0
    F = torch.stack([frac[n] for n in names])
    m_types = [mobility_type(zcfg, n) for n in names]
    mobile = [m < 0.0 for m in m_types]
    if all(mobile):
        F = torch.ones_like(F)
    else:
        span = zcfg.tau_max - zcfg.tau_min
        # a purely mobile tracer's rates are never used: 1 keeps them finite
        tau_ret = _column_table(tuple(
            1.0 if mob else zcfg.tau_min + (1.0 - m) * span
            for m, mob in zip(m_types, mobile)), dtype, dev)
        tau_rel = _column_table(tuple(
            1.0 if mob else zcfg.tau_min + m * span
            for m, mob in zip(m_types, mobile)), dtype, dev)
        df = (-F * dt / tau_ret * growing[:, None].to(dtype)
              + (1.0 - F) * dt / tau_rel * melting[:, None].to(dtype))
        F = torch.clamp(F + df, 0.0, 1.0)
        if any(mobile):
            is_mobile = _column_table(tuple(float(x) for x in mobile),
                                      dtype, dev) > 0.5
            F = torch.where(is_mobile, 1.0, F)

    # --- implicit vertical transport of the mobile phase. Layers k=0
    # (top) .. nb-1 (bottom). Interior interfaces: upwind advection and
    # central diffusion. Bottom: advective outflow at w > 0 / inflow of
    # the ocean concentration at w < 0, plus diffusive exchange across the
    # grid_o sublayer. The coefficients are the same for every tracer.
    dz_s = torch.clamp(dzb, min=cst.puny)
    wP = torch.clamp(w, min=0.0)     # downward component
    wM = torch.clamp(-w, min=0.0)    # upward component
    Dif = D / dz_s
    v_bot = D_MOLECULAR / max(zcfg.grid_o, 1e-4)

    C = torch.clamp(torch.stack([trc[n] for n in names]), min=0.0)
    Cm = C * F                       # mobile bulk concentration
    Cs = C - Cm                      # stationary (attached) part
    # the mixed-layer concentrations, (nz, 1, 1, 1), or (nz, ncat, ny, nx)
    # where `ocean` overrides a default
    if ocean:
        ocn = torch.stack([
            torch.broadcast_to(torch.as_tensor(ocean[n], dtype=dtype,
                                               device=dev), dz.shape)
            if n in ocean else torch.full(dz.shape,
                                          ocean_concentration(zcfg, n),
                                          dtype=dtype, device=dev)
            for n in names])
    else:
        ocn = _column_table(tuple(ocean_concentration(zcfg, n)
                                  for n in names), dtype, dev)[:, 0]

    # the couplings, and each column's excess over them: the unit storage
    # term, plus the bottom layer's outflow to the ocean (lam is the same
    # in every layer of a column, so what layer k sends to k+1 is what
    # k+1 receives)
    lam = torch.broadcast_to(rdiv(dt, dz_s), phi.shape)
    adv_dn = wP[:, :-1]              # from k   -> k+1
    adv_up = wM[:, :-1]              # from k+1 -> k
    dif = Dif[:, :-1]
    upper = torch.zeros_like(phi)
    upper[:, :-1] += -lam[:, :-1] * (adv_up + dif)
    lower = torch.zeros_like(phi)
    lower[:, 1:] += -lam[:, 1:] * (adv_dn + dif)
    wbot = w[:, -1]
    excess = torch.ones_like(phi)
    excess[:, -1] += lam[:, -1] * (torch.clamp(wbot, min=0.0) + v_bot)

    Cbc = phi[:, -1] * ocn                         # (nz, ncat, ny, nx)
    rhs = Cm
    rhs[:, :, -1] += lam[:, -1] * (torch.clamp(-wbot, min=0.0) + v_bot) * Cbc
    if top_amount is not None:
        rhs[:, :, 0] += top_amount / dz_s[:, 0]

    Cm_new = torch.clamp(tridiag_solve(lower, upper, excess, rhs), min=0.0)
    # new-ice entrainment: bottom growth adds ocean tracer into the bottom
    # layer (initbio_frac; frazil_scav for frazil ice), diluted over the
    # brine column it joins
    entrain = ((zcfg.initbio_frac * congel
                + zcfg.frazil_scav * frazil[None]) * ocn
               / torch.clamp(hbr, min=cst.puny))
    Cm_new[:, :, -1] += torch.where(held, entrain, 0.0)
    C_new = torch.where(held[:, None], Cm_new + Cs,
                        torch.where(mask[:, None], ocn[:, :, None], 0.0))

    # net flux to the ocean from the boundary fluxes, per unit cell area,
    # positive into the ocean
    Cb = Cm_new[:, :, -1]
    out_adv = torch.clamp(wbot, min=0.0) * Cb
    in_adv = (torch.clamp(-wbot, min=0.0) + v_bot) * Cbc
    ex_dif = v_bot * Cb
    fl = lsum(torch.where(held, aicen * (out_adv + ex_dif - in_adv),
                               0.0), dim=1)
    # a thin column gives the ocean what it held above the mixed layer's
    # concentrations and what its snow released
    release = lsum(C - ocn[:, :, None], dim=2) * dz
    if top_amount is not None:
        release = release + top_amount
    fl = fl + lsum(torch.where(thin, aicen * release, 0.0), dim=1) / dt

    if isinstance(chl_tot, torch.Tensor):
        chl_int = lsum(lsum(torch.where(mask[:, None], chl_tot * dzb, 0.0)
                            * aicen[:, None], 1))
    else:
        chl_int = zero2

    # interior-state profiles for history (area-weighted category sums on
    # the bio grid): brine temperature, porosity, in-ice PAR, diffusivity,
    # permeability (Freitag 1999 phi^3)
    wcat = torch.where(mask[:, None], aicen[:, None], 0.0)
    perm = 3.0e-8 * (phi * (phi * phi))
    diags = {
        "bTizn": lsum(wcat * T_layer, dim=0),
        "bphizn": lsum(wcat * phi, dim=0),
        "zfswin": lsum(wcat * PAR, dim=0),
        "iDin": lsum(wcat * D, dim=0),
        "ikin": lsum(wcat * perm, dim=0),
        "upNO": upNO, "upNH": upNH, "PP_net": PP_net,
    }
    return ZbgcOut(trc={n: C_new[i] for i, n in enumerate(names)},
                   frac={n: F[i] for i, n in enumerate(names)},
                   flux_ocn={n: fl[i] for i, n in enumerate(names)},
                   grow_net=grow_net, chl_int=chl_int, diags=diags,
                   snow=snow_new)
