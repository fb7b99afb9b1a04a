"""The transports other than the exact remap: first-order upwind, van Leer
MUSCL and `remap_q` (PyTorch port of cice_tpu/dynamics/transport.py;
reference ice_transport_driver.F90 `transport_upwind`:708,
`state_to_work`/`work_to_state`, `upwind_field`:1780).

The state is packed into one (narr, ny, nx) work tensor from the tracer
registry: each tracer is multiplied by its weight chain (base area or
volume times its parent tracers) before advection and divided by it after
(the reference's trcr_depend / trcr_base / nt_strata). These schemes run
on no CUDA kernel, in the JAX package as in the port.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import constants as cst
from ..constants import (FIELD_LOC_CENTER, FIELD_LOC_EFACE, FIELD_LOC_NFACE,
                         FIELD_LOC_NECORNER, FIELD_TYPE_SCALAR,
                         FIELD_TYPE_VECTOR)
from ..core.grid import Grid
from ..core.halo import shift
from ..model.state import DEP_AICE, DEP_VICE, DEP_VSNO, State


def _shc(f, dj, di, bc):
    return shift(f, dj, di, bc=bc, loc=FIELD_LOC_CENTER,
                 ftype=FIELD_TYPE_SCALAR)


def edge_velocities(grid: Grid, uvel, vvel, grid_ice: str = "B",
                    uvelE=None, vvelN=None):
    """E-face u and N-face v (transport_upwind:779-800): on the B grid the
    mean of the two corner velocities along each edge; C and CD grids
    carry the face velocities."""
    if grid_ice in ("C", "CD"):
        return uvelE, vvelN
    shv = lambda f, dj, di: shift(f, dj, di, bc=grid.bc,
                                  loc=FIELD_LOC_NECORNER,
                                  ftype=FIELD_TYPE_VECTOR)
    uee = 0.5 * (uvel + shv(uvel, -1, 0))   # uvel(i,j) + uvel(i,j-1)
    vnn = 0.5 * (vvel + shv(vvel, 0, -1))   # vvel(i,j) + vvel(i-1,j)
    return uee, vnn


# ---------------------------------------------------------------------------
# state <-> work packing driven by the tracer registry
# ---------------------------------------------------------------------------

def _weight_chain(spec, aicen, vicen, vsnon, trcrn, by_name):
    """A tracer's weight: its dependency base times its whole chain of
    parent tracers (e.g. hpnd on level ice weighs aicen * alvl * apnd)."""
    w = {DEP_AICE: aicen, DEP_VICE: vicen, DEP_VSNO: vsnon}[spec.depend]
    p = spec.parent
    while p is not None:
        w = w * trcrn[p]
        p = by_name[p].parent
    return w


def state_to_work(state: State, registry) -> torch.Tensor:
    """Pack (aice0; per category aicen, vicen, vsnon and the weighted
    tracers) into one (narr, ny, nx) tensor (state_to_work)."""
    fields = [state.aice0]
    aicen, vicen, vsnon, trcrn = (state.aicen, state.vicen, state.vsnon,
                                  state.trcrn)
    by_name = {s.name: s for s in registry}
    for n in range(aicen.shape[0]):
        fields += [aicen[n], vicen[n], vsnon[n]]
        cat = {k: v[n] for k, v in trcrn.items()}
        for spec in registry:
            w = _weight_chain(spec, aicen[n], vicen[n], vsnon[n], cat,
                              by_name)
            t = trcrn[spec.name][n]
            if t.ndim == 3:   # (nl, ny, nx)
                fields += [w * t[k] for k in range(t.shape[0])]
            else:
                fields.append(w * t)
    return torch.stack(fields)


def work_to_state(work: torch.Tensor, state: State, registry, tmask,
                  Tf) -> State:
    """Unpack the advected work tensor into the State (work_to_state).
    Tracers recover as work / weight within the registry's range rails;
    vanished categories get zero tracers except Tsfcn, which resets to the
    freezing temperature Tf. The advected aice0 is not used: it is
    1 - sum(aicen)."""
    ncat = state.aicen.shape[0]
    by_name = {s.name: s for s in registry}
    k = 1
    a_list, v_list, s_list = [], [], []
    tr_new: Dict[str, list] = {spec.name: [] for spec in registry}

    def ratio(x, w, lo, hi):
        val = torch.where(w > cst.puny, x / torch.clamp(w, min=cst.puny),
                          0.0)
        if lo > -1e30 or hi < 1e30:
            val = torch.clamp(val, lo, hi)
        return val

    for n in range(ncat):
        aicen = torch.where(tmask, torch.clamp(work[k], min=0.0), 0.0)
        vicen = torch.where(tmask, torch.clamp(work[k + 1], min=0.0), 0.0)
        vsnon = torch.where(tmask, torch.clamp(work[k + 2], min=0.0), 0.0)
        k += 3
        a_list.append(aicen)
        v_list.append(vicen)
        s_list.append(vsnon)
        cat_tr: Dict[str, torch.Tensor] = {}
        for spec in registry:
            w = _weight_chain(spec, aicen, vicen, vsnon, cat_tr, by_name)
            t = state.trcrn[spec.name]
            lo, hi = spec.lo, spec.hi
            if t.ndim == 4:
                nl = t.shape[1]
                val = torch.stack([ratio(work[k + i], w, lo, hi)
                                   for i in range(nl)])
                k += nl
            else:
                val = ratio(work[k], w, lo, hi)
                k += 1
                if spec.name == "Tsfcn":
                    val = torch.where(w > cst.puny, val, Tf)
            cat_tr[spec.name] = val
            tr_new[spec.name].append(val)
    trcrn = {name: torch.stack(vals) for name, vals in tr_new.items()}
    return state.replace(aicen=torch.stack(a_list),
                         vicen=torch.stack(v_list),
                         vsnon=torch.stack(s_list), trcrn=trcrn)


# ---------------------------------------------------------------------------
# first-order upwind (upwind_field:1780)
# ---------------------------------------------------------------------------

def upwind_field(grid: Grid, phi: torch.Tensor, uee, vnn,
                 dt: float) -> torch.Tensor:
    """Conservative first-order upwind update of phi (narr, ny, nx). The
    edge lengths are masked by the face masks, so no flux leaves the
    ocean."""
    bc = grid.bc
    phi_e = _shc(phi, 0, 1, bc)
    phi_n = _shc(phi, 1, 0, bc)
    he = grid.HTE * grid.epm
    hn = grid.HTN * grid.npm
    upw = lambda y1, y2, a, h: 0.5 * dt * h * ((a + torch.abs(a)) * y1 +
                                               (a - torch.abs(a)) * y2)
    fe = upw(phi, phi_e, uee[None], he[None])
    fn = upw(phi, phi_n, vnn[None], hn[None])
    fw = shift(fe, 0, -1, bc=bc, loc=FIELD_LOC_EFACE, ftype=FIELD_TYPE_SCALAR)
    fs = shift(fn, -1, 0, bc=bc, loc=FIELD_LOC_NFACE, ftype=FIELD_TYPE_SCALAR)
    return phi - (fe - fw + fn - fs) * grid.tarear[None]


def transport_upwind(grid: Grid, state: State, registry, Tf, dt: float,
                     grid_ice: str = "B") -> State:
    """The whole upwind transport step (transport_upwind:708)."""
    uee, vnn = edge_velocities(grid, state.uvel, state.vvel, grid_ice,
                               state.uvelE, state.vvelN)
    work = upwind_field(grid, state_to_work(state, registry), uee, vnn, dt)
    return work_to_state(work, state, registry, grid.tmask, Tf)


# ---------------------------------------------------------------------------
# van Leer: dimensionally split MUSCL, second order and monotone
# ---------------------------------------------------------------------------

def _vanleer_slope(dphi_up, dphi_dn):
    """Harmonic-mean (van Leer) limited slope; zero at extrema."""
    prod = dphi_up * dphi_dn
    return torch.where(prod > 0.0, 2.0 * prod / torch.where(
        prod > 0.0, dphi_up + dphi_dn, 1.0), 0.0)


def vanleer_sweep(grid: Grid, phi: torch.Tensor, vel_edge, h_edge, dl,
                  dt: float, axis: int) -> torch.Tensor:
    """One dimensionally split MUSCL update of phi (narr, ny, nx) along x
    (axis=-1, E-face velocity) or y (axis=-2, N-face velocity)."""
    bc = grid.bc
    dj, di = (0, 1) if axis == -1 else (1, 0)
    phi_p = _shc(phi, dj, di, bc)
    phi_m = _shc(phi, -dj, -di, bc)
    slope_c = _vanleer_slope(phi - phi_m, phi_p - phi)
    phi_pp = _shc(phi_p, dj, di, bc)
    slope_p = _vanleer_slope(phi_p - phi, phi_pp - phi_p)

    u = vel_edge[None]
    cfl = torch.clamp(torch.abs(u) * dt / dl[None], max=1.0)
    val_left = phi + 0.5 * slope_c * (1.0 - cfl)       # u > 0: donor here
    val_right = phi_p - 0.5 * slope_p * (1.0 - cfl)    # u < 0: donor next
    flux = dt * h_edge[None] * u * torch.where(u >= 0.0, val_left,
                                               val_right)
    floc = FIELD_LOC_EFACE if axis == -1 else FIELD_LOC_NFACE
    flux_m = shift(flux, -dj, -di, bc=bc, loc=floc, ftype=FIELD_TYPE_SCALAR)
    return phi - (flux - flux_m) * grid.tarear[None]


def transport_vanleer(grid: Grid, state: State, registry, Tf, dt: float,
                      grid_ice: str = "B") -> State:
    """Second-order monotone dimensionally split MUSCL transport
    (advection='vanleer'), x then y."""
    uee, vnn = edge_velocities(grid, state.uvel, state.vvel, grid_ice,
                               state.uvelE, state.vvelN)
    uee = uee * grid.epm
    vnn = vnn * grid.npm
    work = state_to_work(state, registry)
    work = vanleer_sweep(grid, work, uee, grid.HTE * grid.epm, grid.dxT, dt,
                         axis=-1)
    work = vanleer_sweep(grid, work, vnn, grid.HTN * grid.npm, grid.dyT, dt,
                         axis=-2)
    return work_to_state(work, state, registry, grid.tmask, Tf)


def transport_remap(grid: Grid, state: State, registry, Tf, dt: float,
                    grid_ice: str = "B") -> State:
    """Unsplit departure-region remap of the packed densities
    (advection='remap_q', dynamics/remap.py)."""
    from .remap import horizontal_remap
    work = horizontal_remap(grid, state_to_work(state, registry),
                            state.uvel, state.vvel, dt, grid_ice=grid_ice,
                            uvelE=state.uvelE, vvelN=state.vvelN)
    return work_to_state(work, state, registry, grid.tmask, Tf)


#: the transport of each `advection` other than 'remap' (the exact remap,
#: dynamics/remap_exact.py) and 'none' (no transport)
ADVECT = {"upwind": transport_upwind, "remap_q": transport_remap,
          "vanleer": transport_vanleer}
