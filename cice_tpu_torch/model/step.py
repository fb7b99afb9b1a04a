"""Timestep orchestration (PyTorch port of the dynamics-transport part of
cice_tpu/model/step.py; reference ice_step_mod.F90 `step_dyn_horiz`:969 and
the dynamics/transport supercycle of CICE_RunMod.F90:287-322).

`step_dyn_transport` is the body of the ndtd supercycle of `model_step`
(cice_tpu/model/step.py:796-845) without ridging: B-grid EVP dynamics, then
exact incremental remapping. Thermodynamics, ridging, the ocean mixed layer
and the full `model_step` come with ROADMAP: slice 2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..columns import itd as itd_mod
from ..columns.ridging import ice_strength
from ..core.grid import Grid, grid_average_X2Y
from ..dynamics.common import deformations_B, dyn_prep, evp_params
from ..dynamics.evp import evp_ocean_stress, evp_solve
from .flux import Forcing
from .state import State, tracer_registry


@dataclass(frozen=True)
class ModelStatic:
    """Per-run constants."""
    cfg: object
    hin_max: Tuple[float, ...]
    registry: tuple

    @classmethod
    def build(cls, cfg):
        hin_max = tuple(itd_mod.category_bounds(
            cfg.domain.ncat, cfg.grid.kcatbound, cfg.domain.nilyr,
            cfg.thermo.kitd))
        return cls(cfg=cfg, hin_max=hin_max, registry=tracer_registry(cfg))


def step_dyn_horiz(ms: ModelStatic, grid: Grid, state: State, fc: Forcing,
                   strairx_T, strairy_T, dt: float):
    """Horizontal dynamics, B-grid EVP (reference step_dyn_horiz:969,
    kdyn=1). evp_algorithm 'fused_pallas' runs the fused CUDA EVP kernel
    (kernels/evp.py; its plain version on CPU tensors), 'standard_2d' the
    plain PyTorch loop."""
    cfg = ms.cfg
    d = cfg.dynamics
    if cfg.grid.grid_ice != "B":
        raise NotImplementedError(
            f"grid_ice={cfg.grid.grid_ice!r} dynamics are not ported yet "
            "(ROADMAP: C/CD, VP, EAP, upwind and vanleer)")
    if d.kdyn != 1:
        raise NotImplementedError(
            f"kdyn={d.kdyn} (EAP/VP) is not ported yet (ROADMAP: C/CD, VP, "
            "EAP, upwind and vanleer)")
    if d.evp_algorithm == "wide_halo":
        raise NotImplementedError(
            "evp_algorithm='wide_halo' is not ported yet (ROADMAP: "
            "multi-GPU evp_wide over torch.distributed)")
    if cfg.forcing.formdrag:
        raise NotImplementedError(
            "form drag is not ported yet (ROADMAP: column options)")
    p = evp_params(d, dt)
    strength = ice_strength(state.aicen, state.vicen, state.aice, state.vice,
                            d)
    prep = dyn_prep(grid, d, dt, aice=state.aice, vice=state.vice,
                    vsno=state.vsno, aiceU_prev_mask=state.iceUmask,
                    uvel=state.uvel, vvel=state.vvel,
                    strairxT=strairx_T, strairyT=strairy_T,
                    uocn_T=fc.uocn, vocn_T=fc.vocn,
                    ss_tltx_T=fc.ss_tltx, ss_tlty_T=fc.ss_tlty)
    uocnU = grid_average_X2Y("S", fc.uocn, "T", "U", grid)
    vocnU = grid_average_X2Y("S", fc.vocn, "T", "U", grid)

    if d.evp_algorithm == "fused_pallas":
        from ..kernels.evp import evp_solve_fused
        solve = evp_solve_fused
    else:
        solve = evp_solve
    u, v, sp, sm, s12, strintx, strinty, taubx, tauby = solve(
        grid, p, prep, strength, state.stressp, state.stressm,
        state.stress12, uocn=uocnU, vocn=vocnU)

    strocnx, strocny = evp_ocean_stress(prep, u, v, uocnU, vocnU)
    divu, shear, Delta = deformations_B(grid, u, v, p, dt)
    state = state.replace(uvel=u, vvel=v, stressp=sp, stressm=sm,
                          stress12=s12, iceUmask=prep.iceUmask)
    dyn_diags = dict(strintx=strintx, strinty=strinty, taubx=taubx,
                     tauby=tauby, strocnx=strocnx, strocny=strocny,
                     divu=divu, shear=shear, Delta=Delta, strength=strength)
    return state, dyn_diags


def resolve_remap_kernel(cfg, grid: Grid, dtype: torch.dtype) -> str:
    """The transport engine for remap_kernel='auto' (mirrors
    cice_tpu/model/step.py:806-826): the fused CUDA kernel on a CUDA device
    with f32 state and neither tripole nor y-cyclic boundaries, else the
    plain path (the JAX package's 'xla')."""
    fk = cfg.dynamics.remap_kernel
    if fk != "auto":
        return fk
    if (grid.device.type == "cuda" and dtype == torch.float32
            and not grid.bc.tripole and not grid.bc.y_cyclic):
        return "fused_full"
    return "xla"


def step_dyn_transport(ms: ModelStatic, grid: Grid, state: State,
                       fc: Forcing, strairx_T, strairy_T, dt: float):
    """The ndtd dynamics/transport supercycle of one thermo step, without
    ridging (cice_tpu/model/step.py:796-845). Returns (state, dyn_diags,
    tchecks): the last sub-step's dynamics diagnostics and the transport
    checks merged over sub-steps (flags or-ed, errors max-ed)."""
    cfg = ms.cfg
    if cfg.dynamics.kridge >= 1:
        raise NotImplementedError(
            "ridging (kridge=1) is not ported yet (ROADMAP: slice 2); use "
            "dynamics.kridge=-1")
    tchecks: dict = {}
    if cfg.dynamics.kdyn < 1:
        z = torch.zeros(grid.shape, dtype=state.aicen.dtype,
                        device=state.aicen.device)
        dyn = {k: z for k in ("strocnx", "strocny", "divu", "shear", "Delta",
                              "strintx", "strinty", "taubx", "tauby",
                              "strength")}
        return state, dyn, tchecks
    ndtd = max(cfg.setup.ndtd, 1)
    dt_dyn = dt / ndtd
    for _ in range(ndtd):
        state, dyn = step_dyn_horiz(ms, grid, state, fc, strairx_T,
                                    strairy_T, dt_dyn)
        if cfg.dynamics.ktransport < 1:
            continue
        if cfg.dynamics.advection != "remap":
            raise NotImplementedError(
                f"advection={cfg.dynamics.advection!r} is not ported yet "
                "(ROADMAP: C/CD, VP, EAP, upwind and vanleer)")
        from ..dynamics.remap_exact import horizontal_remap_exact
        fk = resolve_remap_kernel(cfg, grid, state.aicen.dtype)
        state, td = horizontal_remap_exact(
            grid, state, ms.registry, fc.Tf, dt_dyn,
            grid_ice=cfg.grid.grid_ice, l_dp_midpt=cfg.dynamics.l_dp_midpt,
            conserv_check=cfg.setup.conserv_check,
            monotonicity_check=cfg.dynamics.monotonicity_check,
            flux_kernel=fk)
        for k, v in td.items():
            prev = tchecks.get(k)
            tchecks[k] = v if prev is None else \
                (prev | v if v.dtype == torch.bool else torch.maximum(prev, v))
    return state, dyn, tchecks
