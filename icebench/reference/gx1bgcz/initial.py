"""CICE's default initial state with the brine height and the z tracers
(the `ice` reference's `set_state_var`, then the biogeochemical part of a
frozen copy of the program's model/driver.py `set_state_var`; reference
ice_init.F90 `set_state_var`:3266, init_bgc, init_hbrine)."""

from __future__ import annotations

import torch

from ..ice.core.grid import Grid
from ..ice.model.initial import _scalar, set_state_var as ice_state_var
from ..ice.model.state import State


def set_state_var(cfg, grid: Grid, state: State, Tf) -> State:
    """Ice poleward of 60 degrees over ocean, parabolic ITD, linear
    temperature profiles; where there is ice the z tracers start at their
    mixed-layer concentrations (algae, DMSPp, PON, DON and Fep at fixed
    seeds), fully mobile, and the brine column fills the ice (fbri = 1)."""
    state = ice_state_var(cfg, grid, state, Tf)
    trcrn = dict(state.trcrn)
    aicen = state.aicen
    dtp, dev = aicen.dtype, aicen.device

    def _init_bgc(nm, v0):
        if nm not in trcrn:
            return
        m = aicen > 0
        if trcrn[nm].ndim == 4:
            m = m[:, None]
        trcrn[nm] = torch.where(m, _scalar(v0, dtp, dev), 0.0).expand_as(
            trcrn[nm]).clone()

    z = cfg.zbgc
    if "bgc_Nit" in trcrn:
        _init_bgc("bgc_Nit", z.nit_data)
        _init_bgc("bgc_N", 0.5)
    for nm, v0 in (("bgc_N2", 0.3), ("bgc_N3", 0.2),
                   ("bgc_Am", z.amm_data), ("bgc_Sil", z.sil_data),
                   ("bgc_DMSPp", 0.1), ("bgc_DMSPd", z.dms_data),
                   ("bgc_DMS", z.dms_data), ("bgc_PON", 0.1),
                   ("bgc_DON", 1.0), ("bgc_Fed", z.fed_data),
                   ("bgc_Fep", 0.1), ("bgc_hum", z.hum_data),
                   ("bgc_DOC1", z.doc_data), ("bgc_DOC2", z.doc_data),
                   ("bgc_DOC3", z.doc_data), ("bgc_DIC1", z.dic_data)):
        _init_bgc(nm, v0)
    # the mobile fractions start fully mobile
    for nm in list(trcrn):
        if nm.endswith("_mf"):
            _init_bgc(nm, 1.0)
    if "fbri" in trcrn:
        trcrn["fbri"] = torch.where(aicen > 0, 1.0, 0.0).to(dtp)
    return state.replace(trcrn=trcrn)
