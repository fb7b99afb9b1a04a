"""The tracer registry and the zeros of the configurations this reference
carries: the `ice` reference's tracers, then the brine height `fbri` and
the z tracers, each with its mobile fraction and snow reservoir (a frozen
copy of the program's model/state.py `tracer_registry`, reference
count_tracers, cut to those groups)."""

from __future__ import annotations

import torch

from ..ice.model import state as ice_state
from ..ice.model.state import DEP_AICE, DEP_VICE, State, TracerSpec
from .columns.zbgc_vertical import z_tracer_names


def tracer_registry(cfg) -> tuple:
    """Active tracer table (reference count_tracers): the `ice`
    reference's, the brine height, then the z tracers: bulk
    concentrations on the nblyr bio grid, conserved per unit brine volume
    vice*fbri (trcr_depend = 2 + nt_fbri), each with a mobile-fraction
    companion and a snow reservoir (content per unit category area)."""
    specs = list(ice_state.tracer_registry(cfg))
    if cfg.tracers.tr_brine:
        specs.append(TracerSpec("fbri", DEP_VICE))
    if cfg.zbgc.z_tracers:
        nb = max(cfg.domain.nblyr, 1)
        for nm in z_tracer_names(cfg.zbgc):
            specs.append(TracerSpec(nm, DEP_VICE, nb, parent="fbri"))
            specs.append(TracerSpec(nm + "_mf", DEP_VICE, nb, parent="fbri",
                                    hi=1.0))
            specs.append(TracerSpec(nm + "_sn", DEP_AICE))
    return tuple(specs)


def zeros_state(cfg, grid) -> State:
    """A state of zeros of this registry's tracers."""
    st = ice_state.zeros_state(cfg, grid)
    ny, nx = grid.shape
    kw = dict(dtype=cfg.np_dtype, device=grid.device)
    shape = lambda s: ((cfg.domain.ncat, s.nlayers, ny, nx) if s.nlayers
                       else (cfg.domain.ncat, ny, nx))
    return st.replace(trcrn={s.name: torch.zeros(shape(s), **kw)
                             for s in tracer_registry(cfg)})
