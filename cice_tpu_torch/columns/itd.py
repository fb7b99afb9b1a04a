"""Ice thickness distribution: category bounds, linear remapping,
aggregation (PyTorch port of cice_tpu/columns/itd.py).

W. H. Lipscomb (2001), Remapping the thickness distribution in sea ice
models, JGR 106(C7). Everything is dense over grid cells: category loops are
unrolled (ncat is 5), per-cell branching becomes torch.where masks. The
category-shift/merge machinery runs on one packed (ncat, NT, ny, nx) tracer
stack with a per-row dependency index.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import constants as cst
from ..core.reductions import host_read
from ..ops import clip, lmean, lsum


def category_bounds(ncat: int, kcatbound: int = 1, nilyr: int = 7,
                    kitd: int = 1) -> np.ndarray:
    """hin_max(0:ncat): thickness category boundaries (m).

    kcatbound: 0 original [Lipscomb 2001 eq. 22], 1 'new' rounded boundaries,
    2 WMO standard, -1 single category. Reference behavior: icepack_init_itd
    (documented in Icepack docs; boundary formulas are standard).
    """
    if kcatbound == -1 or ncat == 1:
        return np.array([0.0, 999.9])
    if kcatbound == 0:
        cc1 = 3.0 / ncat
        cc2 = 15.0 * cc1
        cc3 = 3.0
        bounds = [0.0]
        for n in range(1, ncat + 1):
            x1 = (n - 1) / ncat
            bounds.append(bounds[-1] + cc1 + cc2 * (1.0 + math.tanh(cc3 * (x1 - 1.0))))
        bounds[-1] = 999.9
        return np.array(bounds)
    if kcatbound == 1:
        # rounded boundaries (cice 'new' defaults for ncat=5: .64 1.39 2.47 4.57)
        cc1 = 3.0 / ncat
        cc2 = 15.0 * cc1
        cc3 = 3.0
        bounds = [0.0]
        for n in range(1, ncat + 1):
            x1 = (n - 1) / ncat
            b = bounds[-1] + cc1 + cc2 * (1.0 + math.tanh(cc3 * (x1 - 1.0)))
            bounds.append(100.0 * round(b * 100.0) / 10000.0)
        bounds = [round(b, 6) for b in bounds]
        bounds[-1] = 999.9
        return np.array(bounds)
    if kcatbound == 2:  # WMO
        wmo = {5: [0.0, 0.30, 0.70, 1.20, 2.0, 999.9],
               6: [0.0, 0.15, 0.30, 0.70, 1.20, 2.0, 999.9],
               7: [0.0, 0.10, 0.15, 0.30, 0.70, 1.20, 2.0, 999.9]}
        if ncat not in wmo:
            raise ValueError("WMO bounds require ncat in (5,6,7)")
        return np.array(wmo[ncat])
    if kcatbound == 3:
        # asymptotic scheme (ug_case_settings.rst:336): fine resolution for
        # thin ice, boundaries growing without bound toward the thick end:
        # H_n = n / (ncat + 1 - n). Behavioral stand-in for the Icepack
        # formula (source external to the reference repo); e.g. ncat=7 ->
        # 0.14, 0.33, 0.60, 1.0, 1.67, 3.0 m.
        bounds = [0.0] + [n / (ncat + 1.0 - n) for n in range(1, ncat)]
        bounds.append(999.9)
        return np.array(bounds)
    raise ValueError(f"unknown kcatbound {kcatbound}")


def initial_itd_profile(ncat: int, hin_max: np.ndarray, hbar: float = 3.0):
    """Initial area fractions per category, peaked near hbar
    (reference set_state_var ice_init.F90:3266 'parabolic' profile)."""
    ainit = np.zeros(ncat)
    hinit = np.zeros(ncat)
    for n in range(ncat):
        hl, hu = hin_max[n], min(hin_max[n + 1], 2.0 * hbar)
        hinit[n] = 0.5 * (hl + min(hu, hin_max[n + 1] if n < ncat - 1 else hl + 1.0))
        if hu > hl:
            xl, xu = hl / hbar, min(hu, 2.0 * hbar) / hbar
            if xl < 2.0:
                # integral of parabola a(h) ~ max(0, h(2-h/hbar)) normalized
                f = lambda x: x * x - x ** 3 / 3.0
                ainit[n] = max(f(min(xu, 2.0)) - f(min(xl, 2.0)), 0.0)
    s = ainit.sum()
    if s > 0:
        ainit = 0.95 * ainit / s   # total initial concentration 0.95
    for n in range(ncat):
        hinit[n] = 0.5 * (hin_max[n] + hin_max[n + 1]) if n < ncat - 1 else hin_max[n] + 0.5
    return ainit, hinit


# ---------------------------------------------------------------------------
# packed-tracer utilities
# ---------------------------------------------------------------------------

def flat_dep_table(registry):
    """(dep_idx (NT,), layout) flattening registry tracers layer by layer;
    dep_idx[k] in (DEP_AICE, DEP_VICE, DEP_VSNO)."""
    dep_idx = []
    layout = []
    for spec in registry:
        nl = spec.nlayers or 0
        layout.append((spec.name, len(dep_idx), nl))
        for _ in range(max(nl, 1)):
            dep_idx.append(spec.depend)
    return np.asarray(dep_idx), tuple(layout)


def name_offsets(registry):
    """name -> (row offset, row count) into the packed (ncat, NT, ny, nx)
    stack."""
    _, layout = flat_dep_table(registry)
    return {nm: (o, max(nl, 1)) for nm, o, nl in layout}


@functools.lru_cache(maxsize=16)
def dep_index(registry, device) -> torch.Tensor:
    """(NT,) int64 dependency index of the packed rows on `device`, built
    once per (registry, device)."""
    didx, _ = flat_dep_table(registry)
    return torch.as_tensor(didx, dtype=torch.int64, device=device)


def pack_tracers(trcrn, registry):
    """Stack registry tracers into (ncat, NT, ny, nx), layers flattened."""
    planes = []
    for spec in registry:
        t = trcrn[spec.name]
        planes.append(t if t.ndim == 4 else t[:, None])
    return torch.cat(planes, dim=1)


def unpack_tracers(trm, registry):
    out = {}
    k = 0
    for spec in registry:
        nl = spec.nlayers or 0
        n = max(nl, 1)
        sl = trm[:, k:k + n]
        out[spec.name] = sl if nl else sl[:, 0]
        k += n
    return out


def _dep_weight(didx: torch.Tensor, wa, wv, ws):
    """(NT, ...) per-row merge weight selected by dependency."""
    return torch.stack([wa, wv, ws])[didx]


def _packed(trcrn, registry):
    """(per-category list of (NT, ny, nx) rows, packed_in)."""
    packed_in = not isinstance(trcrn, dict)
    tr = list(trcrn) if packed_in else list(pack_tracers(trcrn, registry))
    return tr, packed_in


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def aggregate_area(aicen):
    return lsum(aicen, dim=0)


def compute_tracers(aicen, vicen, vsnon, trcrn, registry):
    """Cell-mean tracer values: weight per dependency, divide by the
    aggregate weight."""
    from ..model.state import DEP_AICE, DEP_VICE, DEP_VSNO
    out = {}
    denom = {DEP_AICE: lsum(aicen), DEP_VICE: lsum(vicen),
             DEP_VSNO: lsum(vsnon)}
    wgt = {DEP_AICE: aicen, DEP_VICE: vicen, DEP_VSNO: vsnon}
    for spec in registry:
        w = wgt[spec.depend]
        t = trcrn[spec.name]
        if t.ndim == 4:
            w = w[:, None]
        num = lsum(t * w, dim=0)
        den = denom[spec.depend]
        den = den[None] if t.ndim == 4 else den
        out[spec.name] = torch.where(
            den > cst.puny, num / torch.clamp(den, min=cst.puny), 0.0)
    return out


# ---------------------------------------------------------------------------
# linear remapping of the ITD (kitd=1), Lipscomb 2001
# ---------------------------------------------------------------------------

def _linear_g(a, h, lo, hi, puny):
    """Limited linear thickness distribution g(h) on [lo, hi] (Lipscomb 2001
    eqs. 13-15): fit g(h) = g0 + g1*(h - hl_eff) to the category's (area,
    mean thickness); where the fit would go negative at an endpoint, shrink
    the support to a triangle. Returns (g0, g1, hl_eff, hr_eff)."""
    eta = torch.clamp(hi - lo, min=puny)
    x = torch.clamp((h - lo) / eta, 0.0, 1.0)
    g0_mid = a / eta * (4.0 - 6.0 * x)
    g1_mid = a / (eta * eta) * (12.0 * x - 6.0)
    w_r = torch.clamp(3.0 * (1.0 - x) * eta, min=puny)
    w_l = torch.clamp(3.0 * x * eta, min=puny)

    right = x > 2.0 / 3.0
    left = x < 1.0 / 3.0
    hl_eff = torch.where(right, hi - w_r, lo)
    hr_eff = torch.where(left, lo + w_l, hi)
    g0 = torch.where(right, 0.0, torch.where(left, 2.0 * a / w_l, g0_mid))
    g1 = torch.where(right, 2.0 * a / (w_r * w_r),
                     torch.where(left, -2.0 * a / (w_l * w_l), g1_mid))
    return g0, g1, hl_eff, hr_eff


def _transfer_integrals(g0, g1, hl_eff, hr_eff, c1, c2):
    """(area, volume) integrals of g over [c1, c2] clipped to the support."""
    span = hr_eff - hl_eff
    y1 = clip(c1 - hl_eff, 0.0, span)
    y2 = clip(c2 - hl_eff, 0.0, span)
    da = g0 * (y2 - y1) + 0.5 * g1 * (y2 * y2 - y1 * y1)
    dv = hl_eff * da + 0.5 * g0 * (y2 * y2 - y1 * y1) \
        + g1 * (y2 ** 3 - y1 ** 3) / 3.0
    return da, dv


def vicen_safe_h(v, a):
    return torch.where(a > cst.puny, v / torch.clamp(a, min=cst.puny), 0.0)


def linear_itd_remap(aicen, vicen, vsnon, trcrn, hin_max, hicen_old,
                     hicen_new, registry):
    """Restore fixed thickness-category boundaries after vertical
    growth/melt (Lipscomb 2001 linear remapping): displace the boundaries
    with the thermodynamic growth field, rebuild a limited-linear g(h) per
    displaced category, and move the integral beyond each fixed boundary to
    the neighbour category: area, volume, snow (in proportion to area) and
    tracers (donor values merged with dependency weights). `trcrn` is the
    tracer dict or the packed (ncat, NT, ny, nx) stack."""
    ncat = aicen.shape[0]
    puny = cst.puny
    hin_max = [float(h) for h in hin_max]

    # --- displaced boundaries (Lipscomb eq. 8-12) --------------------------
    hbnew = [torch.zeros_like(aicen[0])]
    for n in range(ncat - 1):
        hb = hin_max[n + 1]
        h1, h2 = hicen_old[n], hicen_old[n + 1]
        d1 = hicen_new[n] - hicen_old[n]
        d2 = hicen_new[n + 1] - hicen_old[n + 1]
        both = (aicen[n] > puny) & (aicen[n + 1] > puny)
        only1 = (aicen[n] > puny) & ~both
        only2 = (aicen[n + 1] > puny) & ~both
        dh21 = h2 - h1
        wide = dh21.abs() > puny
        slope = torch.where(wide, (d2 - d1) / torch.where(wide, dh21, 1.0),
                            0.0)
        dhb = d1 + slope * (hb - h1)
        dhb = torch.where(both, dhb,
                          torch.where(only1, d1, torch.where(only2, d2, 0.0)))
        hbn = hb + dhb
        # keep the displaced boundary within the fixed neighbours' bounds
        hbn = torch.clamp(hbn, hin_max[n] + puny, hin_max[n + 2] - puny)
        hbnew.append(hbn)
    hbnew.append(torch.full_like(aicen[0], hin_max[-1]))

    a = list(aicen)
    v = list(vicen)
    s = list(vsnon)
    didx = dep_index(registry, aicen.device)
    tr, packed_in = _packed(trcrn, registry)

    for n in range(ncat - 1):
        hb_fixed = hin_max[n + 1]
        hb_disp = hbnew[n + 1]
        up = hb_disp > hb_fixed + puny       # ice grew across the boundary
        dn = hb_disp < hb_fixed - puny       # ice melted back across it

        h_dn = vicen_safe_h(v[n], a[n])
        h_dn1 = vicen_safe_h(v[n + 1], a[n + 1])
        g0u, g1u, hlu, hru = _linear_g(a[n], h_dn, hbnew[n], hb_disp, puny)
        dau, dvu = _transfer_integrals(g0u, g1u, hlu, hru, hb_fixed, hb_disp)
        g0d, g1d, hld, hrd = _linear_g(a[n + 1], h_dn1, hb_disp,
                                       hbnew[n + 2], puny)
        dad, dvd = _transfer_integrals(g0d, g1d, hld, hrd, hb_disp, hb_fixed)

        oku = up & (a[n] > puny)
        okd = dn & (a[n + 1] > puny)
        dau = torch.where(oku, clip(dau, 0.0, a[n]), 0.0)
        dvu = torch.where(oku, clip(dvu, 0.0, v[n]), 0.0)
        dad = torch.where(okd, clip(dad, 0.0, a[n + 1]), 0.0)
        dvd = torch.where(okd, clip(dvd, 0.0, v[n + 1]), 0.0)

        # snow moves in proportion to area moved
        dsu = torch.where(a[n] > puny,
                          s[n] * dau / torch.clamp(a[n], min=puny), 0.0)
        dsd = torch.where(a[n + 1] > puny,
                          s[n + 1] * dad / torch.clamp(a[n + 1], min=puny),
                          0.0)

        du_ = _dep_weight(didx, dau, dvu, dsu)
        dd_ = _dep_weight(didx, dad, dvd, dsd)
        ru_ = _dep_weight(didx, a[n + 1], v[n + 1], s[n + 1])
        rd_ = _dep_weight(didx, a[n], v[n], s[n])
        t_n, t_n1 = tr[n], tr[n + 1]
        den_u = ru_ + du_
        tr[n + 1] = torch.where(
            den_u > puny,
            (t_n1 * ru_ + t_n * du_) / torch.clamp(den_u, min=puny), t_n1)
        den_d = rd_ + dd_
        tr[n] = torch.where(
            den_d > puny,
            (t_n * rd_ + t_n1 * dd_) / torch.clamp(den_d, min=puny), t_n)

        a[n] = a[n] - dau + dad
        a[n + 1] = a[n + 1] + dau - dad
        v[n] = v[n] - dvu + dvd
        v[n + 1] = v[n + 1] + dvu - dvd
        s[n] = s[n] - dsu + dsd
        s[n + 1] = s[n + 1] + dsu - dsd

    trm = torch.stack(tr)
    return (torch.stack(a), torch.stack(v), torch.stack(s),
            trm if packed_in else unpack_tracers(trm, registry))


def rebin(aicen, vicen, vsnon, trcrn, hin_max, registry, mesh=None):
    """Make sure category mean thicknesses lie within bounds by shifting
    whole parcels to the correct neighbour category. One sweep up + one
    sweep down; in-bounds afterwards for adjacent spills."""
    ncat = aicen.shape[0]
    hin_max = [float(h) for h in hin_max]
    a = list(aicen)
    v = list(vicen)
    s = list(vsnon)
    didx = dep_index(registry, aicen.device)
    tr, packed_in = _packed(trcrn, registry)

    def move(frm, to, moving):
        """Move the masked parcels (whole category content) frm->to. The
        tracer merge runs only when some parcel moves anywhere (one host
        read): after the linear ITD remap that is rare, and an idle merge
        would still rewrite every cell as t*w/w, not bit-for-bit t."""
        if host_read("rebin", moving.any(), mesh):
            wsrc = _dep_weight(didx, a[frm], v[frm], s[frm])
            wdst = _dep_weight(didx, a[to], v[to], s[to])
            wsm = torch.where(moving[None], wsrc, 0.0)
            den = wdst + wsm
            tr[to] = torch.where(
                den > cst.puny,
                (tr[to] * wdst + tr[frm] * wsm) /
                torch.clamp(den, min=cst.puny), tr[to])
        for pool in (a, v, s):
            dm = torch.where(moving, pool[frm], 0.0)
            pool[to] = pool[to] + dm
            pool[frm] = pool[frm] - dm

    for n in range(ncat - 1):        # sweep up
        h = vicen_safe_h(v[n], a[n])
        move(n, n + 1, (a[n] > cst.puny) & (h > hin_max[n + 1]))
    for n in range(ncat - 1, 0, -1):  # sweep down
        h = vicen_safe_h(v[n], a[n])
        move(n, n - 1, (a[n] > cst.puny) & (h < hin_max[n]))

    trm = torch.stack(tr)
    return (torch.stack(a), torch.stack(v), torch.stack(s),
            trm if packed_in else unpack_tracers(trm, registry))


def cleanup_itd(aicen, vicen, vsnon, trcrn, registry, *, puny=cst.puny,
                dt=None, sal_ref=4.0):
    """Zero out negligible categories, renormalize aice <= 1. With `dt`
    given, the zapped mass and enthalpy are returned as ocean fluxes (a 5th
    element {fresh, fsalt, fhocn}) so the freshwater/heat budgets stay
    closed; without dt the 4-tuple is returned."""
    keep = (aicen > puny) & (vicen > 0.0)
    vice_rm = lsum(torch.where(keep, 0.0, vicen), dim=0)
    vsno_rm = lsum(torch.where(keep, 0.0, vsnon), dim=0)
    packed_in = not isinstance(trcrn, dict)
    if packed_in:
        off = name_offsets(registry)
        qice_m = qsno_m = None
        if "qice" in off:
            o, n = off["qice"]
            qice_m = lmean(trcrn[:, o:o + n], 1)
        if "qsno" in off:
            o, n = off["qsno"]
            qsno_m = lmean(trcrn[:, o:o + n], 1)
    else:
        qice_m = lmean(trcrn["qice"], 1) if "qice" in trcrn else None
        qsno_m = lmean(trcrn["qsno"], 1) if "qsno" in trcrn else None
    eice_rm = esno_rm = None
    if dt is not None and qice_m is not None and qsno_m is not None:
        eice_rm = lsum(torch.where(keep, 0.0, qice_m * vicen), dim=0)
        esno_rm = lsum(torch.where(keep, 0.0, qsno_m * vsnon), dim=0)
    aicen = torch.where(keep, aicen, 0.0)
    vicen = torch.where(keep, vicen, 0.0)
    vsnon = torch.where(keep, vsnon, 0.0)
    if packed_in:
        trcrn = torch.where(keep[:, None], trcrn, 0.0)
    else:
        trcrn = {k: torch.where(keep[:, None] if t.ndim == 4 else keep,
                                t, 0.0)
                 for k, t in trcrn.items()}
    aice = lsum(aicen, dim=0)
    scale = torch.where(aice > 1.0, 1.0 / torch.clamp(aice, min=puny), 1.0)
    aicen = aicen * scale[None]
    if dt is None:
        return aicen, vicen, vsnon, trcrn
    dt_i = 1.0 / dt
    flux = dict(
        fresh=(cst.rhoi * vice_rm + cst.rhos * vsno_rm) * dt_i,
        fsalt=cst.rhoi * vice_rm * sal_ref * 1e-3 * dt_i,
        fhocn=((eice_rm + esno_rm) * dt_i if eice_rm is not None
               else torch.zeros_like(vice_rm)))
    return aicen, vicen, vsnon, trcrn, flux
