"""Implicit viscous-plastic (VP) dynamics: Picard (or Anderson) iterations
around a flexible GMRES (PyTorch port of cice_tpu/dynamics/vp.py; reference
ice_dyn_vp.F90 `implicit_solver`:152, `anderson_solver`:663,
`calc_zeta_dPr`:1122, `matvec`:1535, `calc_bvec`:1854, `fgmres`:2737,
`pgmres`:3139).

Each nonlinear iteration freezes the viscosities and the linearised drag,
so the momentum equation is linear in (u, v); its operator is applied
matrix-free with the B-grid bilinear stress divergence of the EVP solver.
Every count is fixed by the configuration (`maxits_nonlin`, `dim_fgmres`,
the restart cycles, `dim_pgmres`) and convergence masks finished work
(`active`, `done`) instead of ending a loop, so the solve makes no host read:
the small least-squares problems are solved on the device too
(`hessenberg_lstsq`, `tall_lstsq`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as cst
from ..core.grid import Grid
from .common import (RHEO_AREA_MIN, DynPrep, EvpParams, evp_params,
                     strain_rates_B, visc_replpress)
from .evp import stress_divergence


class VpViscosity(NamedTuple):
    zetax2: tuple     # per corner (ne, nw, sw, se)
    etax2: tuple
    rep_prs: tuple


def calc_viscosities(grid: Grid, p: EvpParams, strength, DminTarea, uvel,
                     vvel) -> VpViscosity:
    """zeta, eta and the replacement pressure at the 4 T-cell corners from
    the current velocity iterate (calc_zeta_dPr)."""
    sr = strain_rates_B(grid, uvel, vvel, p)
    out = [visc_replpress(strength, DminTarea, D, p)
           for D in (sr.Deltane, sr.Deltanw, sr.Deltasw, sr.Deltase)]
    return VpViscosity(zetax2=tuple(o[0] for o in out),
                       etax2=tuple(o[1] for o in out),
                       rep_prs=tuple(o[2] for o in out))


def _corner_stresses(grid: Grid, p: EvpParams, visc: VpViscosity, uvel,
                     vvel, include_rep: bool):
    """(sp1..4, sm1..4, s121..4) = zeta * strain rates, less the
    replacement pressure with `include_rep`."""
    sr = strain_rates_B(grid, uvel, vvel, p)
    z, e, r = visc.zetax2, visc.etax2, visc.rep_prs
    div = (sr.divune, sr.divunw, sr.divusw, sr.divuse)
    ten = (sr.tensionne, sr.tensionnw, sr.tensionsw, sr.tensionse)
    shr = (sr.shearne, sr.shearnw, sr.shearsw, sr.shearse)
    sp = [z[c] * div[c] - r[c] if include_rep else z[c] * div[c]
          for c in range(4)]
    sm = [e[c] * ten[c] for c in range(4)]
    s12 = [0.5 * e[c] * shr[c] for c in range(4)]
    return sp, sm, s12


def vp_stress_divergence(grid: Grid, p: EvpParams, visc: VpViscosity,
                         uvel, vvel, include_rep: bool):
    """Internal stress force of the VP operator: sigma = zeta * eps (linear
    in u), less the constant replacement pressure with `include_rep`."""
    sp, sm, s12 = _corner_stresses(grid, p, visc, uvel, vvel, include_rep)
    return stress_divergence(grid, *sp, *sm, *s12)


def rep_pressure_force(grid: Grid, visc: VpViscosity):
    """Force of the constant replacement pressure (moved to the right-hand
    side)."""
    r = visc.rep_prs
    z = torch.zeros_like(r[0])
    return stress_divergence(grid, -r[0], -r[1], -r[2], -r[3],
                             z, z, z, z, z, z, z, z)


# ---------------------------------------------------------------------------
# small least squares on the device
# ---------------------------------------------------------------------------

def _masked_triangular_solve(R, g, tol):
    """Back substitution of R y = g in which every row whose diagonal is
    at most `tol` gives y_j = 0 (its row becomes e_j, its right-hand side
    0): the minimum-norm solution where R has zero columns."""
    n = R.shape[1]
    d = torch.diagonal(R)
    bad = d.abs() <= tol
    eye = torch.eye(n, dtype=R.dtype, device=R.device)
    Rm = torch.where(bad[:, None], eye, torch.triu(R))
    gm = torch.where(bad, 0.0, g)
    return torch.linalg.solve_triangular(Rm, gm[:, None], upper=True)[:, 0]


def hessenberg_lstsq(H, beta):
    """min |beta e1 - H y| for an upper Hessenberg H ((m+1) x m) by Givens
    rotations and a masked back substitution: a column whose |R_jj| is at
    most eps * (m+1) * max|R| gets y_j = 0, as the SVD solve of
    `jnp.linalg.lstsq(H, e1, rcond=None)` drops singular values below
    that cutoff. Trailing zero columns of H (an exactly zero residual in
    the Arnoldi process) give the same minimum-norm y. No host read."""
    m = H.shape[1]
    A = torch.zeros((m + 1, m + 1), dtype=H.dtype, device=H.device)
    A[:, :m] = H
    A[0, m] = beta
    for j in range(m):
        a, b = A[j, j], A[j + 1, j]
        r = torch.sqrt(a * a + b * b)
        ok = r > 0
        rs = torch.where(ok, r, 1.0)
        c = torch.where(ok, a / rs, 1.0)
        s = b / rs                                    # 0 where r = 0
        G = torch.stack((torch.stack((c, s)), torch.stack((-s, c))))
        A[j:j + 2, j:] = G @ A[j:j + 2, j:]
    R = A[:m, :m]
    tol = torch.finfo(H.dtype).eps * (m + 1) * R.abs().amax()
    return _masked_triangular_solve(R, A[:m, m], tol)


def tall_lstsq(F, f, rcond: float):
    """min |f - F gamma| for a tall F (n x m, m small) by modified
    Gram-Schmidt QR and a masked back substitution (|R_jj| at most
    rcond * max|R| gives gamma_j = 0), in place of
    `jnp.linalg.lstsq(F, f, rcond=rcond)`; zero columns give its
    minimum-norm gamma. No host read."""
    m = F.shape[1]
    Q = [F[:, j] for j in range(m)]
    R = torch.zeros((m, m), dtype=F.dtype, device=F.device)
    for j in range(m):
        for i in range(j):
            rij = torch.dot(Q[i], Q[j])
            R[i, j] = rij
            Q[j] = Q[j] - rij * Q[i]
        rjj = torch.linalg.vector_norm(Q[j])
        R[j, j] = rjj
        Q[j] = Q[j] / torch.clamp(rjj, min=1e-300)
    qtf = torch.stack([torch.dot(q, f) for q in Q])
    return _masked_triangular_solve(R, qtf, rcond * R.abs().amax())


# ---------------------------------------------------------------------------
# Krylov machinery over stacked (2, ny, nx) vectors
# ---------------------------------------------------------------------------

def fgmres(matvec, b, x0, M, dim: int, restarts: int = 1,
           ortho: str = "mgs", reltol: float = 0.0):
    """Right-preconditioned flexible GMRES (fgmres:2737) on stacked
    (2, ny, nx) vectors: a fixed Krylov dimension `dim` per cycle and a
    fixed number of restart cycles. A cycle whose entry residual is
    already below reltol * |r_0| leaves x unchanged (`active`, a 0-d
    tensor): the reference's tolerance exit without a host read. The
    preconditioner M may itself be an iterative solve (the preconditioned
    vectors Z_j are kept). Modified Gram-Schmidt projects against slots
    0..j only, which gives the reference package's numbers (it masks the
    later, still zero, slots)."""
    eps = 1e-30
    dtype, dev = b.dtype, b.device
    x = x0
    beta0 = None
    active = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(restarts):
        r = b - matvec(x)
        beta = torch.linalg.vector_norm(r)
        if beta0 is None:
            beta0 = beta
        elif reltol > 0.0:
            active = active & (beta > reltol * beta0)
        V = torch.zeros((dim + 1,) + tuple(b.shape), dtype=dtype, device=dev)
        Z = torch.zeros((dim,) + tuple(b.shape), dtype=dtype, device=dev)
        H = torch.zeros((dim + 1, dim), dtype=dtype, device=dev)
        V[0] = r / torch.clamp(beta, min=eps)
        for j in range(dim):
            z = M(V[j])
            w = matvec(z)
            if ortho == "cgs":
                hs = torch.tensordot(V[:j + 1], w, dims=3)
                w = w - torch.tensordot(hs, V[:j + 1], dims=1)
                H[:j + 1, j] = hs
            else:
                for i in range(j + 1):
                    hij = torch.sum(w * V[i])
                    w = w - hij * V[i]
                    H[i, j] = hij
            hlast = torch.linalg.vector_norm(w)
            V[j + 1] = w / torch.clamp(hlast, min=eps)
            H[j + 1, j] = hlast
            Z[j] = z
        y = hessenberg_lstsq(H, beta)
        y = torch.where(active, y, 0.0)
        x = x + torch.tensordot(y, Z, dims=1)
    return x


def _pgmres_preconditioner(matvec, diag, dim: int, ortho: str,
                           reltol: float = 0.0):
    """The 'pgmres' preconditioner (pgmres:3139): an inner GMRES of small
    fixed dimension on the same operator, itself diagonally
    preconditioned (reltol = reltol_pgmres)."""
    Md = lambda t: t / diag

    def M(v):
        return fgmres(matvec, v, torch.zeros_like(v), Md, dim=dim,
                      restarts=1, ortho=ortho, reltol=reltol)
    return M


def _anderson_update(x_hist, f_hist, g_new, x_new, damping):
    """Anderson(m) mixing (anderson_solver:663): from the histories of
    iterates x_k and residuals f_k = G(x_k) - x_k, the accelerated next
    iterate. The small least squares is `tall_lstsq` (rcond 1e-6)."""
    m = len(f_hist) - 1
    if m < 1:
        return g_new
    fk = f_hist[-1]
    dF = [f_hist[i + 1] - f_hist[i] for i in range(m)]
    dX = [x_hist[i + 1] - x_hist[i] for i in range(m)]
    Fm = torch.stack([d.reshape(-1) for d in dF], dim=1)   # (n, m)
    gamma = tall_lstsq(Fm, fk.reshape(-1), 1e-6)
    # safeguard: shrink aggressive extrapolations
    gnorm = torch.sqrt(torch.sum(gamma ** 2))
    gamma = gamma * torch.clamp(1.5 / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
    out = g_new
    for i in range(m):
        out = out - gamma[i] * (dX[i] + dF[i])
    if damping > 0.0:
        out = out * (1.0 - damping) + x_new * damping
    return out


def implicit_solver(grid: Grid, cfg_dyn, prep: DynPrep, strength, *,
                    uocn, vocn, dt: float):
    """Picard + FGMRES implicit VP solve (implicit_solver:152). Returns
    (uvel, vvel, stressp, stressm, stress12, strintx, strinty, taubx,
    tauby, residual history): the corner stresses in the EVP layout for
    diagnostics and restarts, and |F(u_k)| per nonlinear iteration as one
    tensor."""
    p = evp_params(cfg_dyn, dt)
    DminTarea = cfg_dyn.deltaminVP * grid.tarea
    mask = prep.iceUmask
    u, v = prep.uvel, prep.vvel
    anderson = cfg_dyn.algo_nonlin == "anderson"
    res_hist, x_hist, f_hist = [], [torch.stack((u, v))], []
    vrel_prev = None
    active = None   # 0-d: the nonlinear iteration is above reltol_nonlin
    dim = cfg_dyn.dim_fgmres
    restarts = max(1, cfg_dyn.maxits_fgmres // max(dim, 1))
    sgn = torch.sign(torch.where(prep.fm == 0, 1.0, prep.fm))
    # rheology cutoff at near-massless fringe points (rheo_area_min): the
    # implicit operator is near-singular there
    rf = (prep.aiU > RHEO_AREA_MIN).to(u.dtype)

    for it in range(cfg_dyn.maxits_nonlin):
        vrel = prep.aiU * cst.rhow * prep.Cw * torch.sqrt((uocn - u) ** 2 +
                                                          (vocn - v) ** 2)
        Cb = prep.TbU / (torch.sqrt(u ** 2 + v ** 2) + cst.u0)
        if cfg_dyn.use_mean_vrel and not anderson and vrel_prev is not None:
            # average the linearised drag between iterates (use_mean_vrel);
            # not under Anderson, whose mixing needs a stationary map
            vrel = 0.5 * (vrel + vrel_prev)
        vrel_prev = vrel
        visc = calc_viscosities(grid, p, strength, DminTarea, u, v)
        cca = prep.umassdti + vrel * cst.cosw + Cb
        ccb = prep.fm + sgn * vrel * cst.sinw
        cca_safe = torch.where(mask, cca, 1.0)

        def matvec(x, visc=visc, cca_safe=cca_safe, ccb=ccb):
            du, dv = x[0], x[1]
            sx, sy = vp_stress_divergence(grid, p, visc, du, dv,
                                          include_rep=False)
            au = cca_safe * du - ccb * dv - rf * sx
            av = ccb * du + cca_safe * dv - rf * sy
            return torch.stack((torch.where(mask, au, du),
                                torch.where(mask, av, dv)))

        rx, ry = rep_pressure_force(grid, visc)
        rx, ry = rf * rx, rf * ry
        bu = prep.forcex + vrel * prep.waterx + \
            prep.umassdti * prep.uvel_init + rx
        bv = prep.forcey + vrel * prep.watery + \
            prep.umassdti * prep.vvel_init + ry
        b = torch.stack((torch.where(mask, bu, 0.0),
                         torch.where(mask, bv, 0.0)))

        if cfg_dyn.precond == "pgmres":
            M = _pgmres_preconditioner(
                matvec, cca_safe,
                max(2, min(cfg_dyn.dim_pgmres, cfg_dyn.maxits_pgmres)),
                cfg_dyn.ortho_type, reltol=cfg_dyn.reltol_pgmres)
        elif cfg_dyn.precond == "diag":
            M = lambda x, c=cca_safe: x / c
        else:
            M = lambda x: x

        # the nonlinear residual |A(u_k) u_k - b(u_k)| before the solve;
        # iterates freeze once it falls below reltol_nonlin * |F(u_0)|
        x_k = torch.stack((u, v))
        res = torch.linalg.vector_norm(matvec(x_k) - b)
        res_hist.append(res)
        done = res <= cfg_dyn.reltol_nonlin * res_hist[0]
        active = ~done if active is None else (active & ~done)

        x = fgmres(matvec, b, x_k, M, dim=dim, restarts=restarts,
                   ortho=cfg_dyn.ortho_type, reltol=cfg_dyn.reltol_fgmres)
        keep = mask & active
        g = torch.stack((torch.where(keep, x[0], u),
                         torch.where(keep, x[1], v)))
        g = torch.where(mask, g, 0.0)

        if anderson:
            f_hist.append(g - x_k)
            if len(f_hist) > cfg_dyn.dim_andacc + 1:
                f_hist.pop(0)
                x_hist.pop(0)
            acc = g if it < cfg_dyn.start_andacc else _anderson_update(
                x_hist, f_hist, g, x_k, cfg_dyn.damping_andacc)
            u = torch.where(mask, acc[0], 0.0)
            v = torch.where(mask, acc[1], 0.0)
            x_hist.append(torch.stack((u, v)))
        else:
            u, v = g[0], g[1]

    # the final stress state for diagnostics and restarts (EVP layout)
    visc = calc_viscosities(grid, p, strength, DminTarea, u, v)
    sp, sm, s12 = _corner_stresses(grid, p, visc, u, v, include_rep=True)
    strintx, strinty = stress_divergence(grid, *sp, *sm, *s12)
    speed = torch.sqrt(u ** 2 + v ** 2) + cst.u0
    return (u, v, torch.stack(sp), torch.stack(sm), torch.stack(s12),
            strintx, strinty, -u * prep.TbU / speed, -v * prep.TbU / speed,
            torch.stack(res_hist))
