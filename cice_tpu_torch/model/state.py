"""Prognostic model state (PyTorch port of cice_tpu/model/state.py).

One dataclass of tensors holds the full prognostic state; tracers are a
name -> tensor dict driven by the tracer registry. `state_leaves` gives its
tensors in the order restart files number them. Layout: grid dims last,
(..., ny, nx); categories lead, (ncat, ny, nx); layers between,
(ncat, nlyr, ny, nx).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

import torch

# Tracer dependency kinds (reference trcr_depend values):
DEP_AICE = 0    # tracer carried per unit ice area fraction
DEP_VICE = 1    # per unit ice volume
DEP_VSNO = 2    # per unit snow volume


@dataclass(frozen=True)
class TracerSpec:
    name: str
    depend: int               # DEP_AICE / DEP_VICE / DEP_VSNO
    nlayers: int = 0          # 0 => (ncat, ny, nx); >0 => (ncat, nlayers, ny, nx)
    parent: str | None = None  # e.g. hpnd/ipnd ride on apnd
    # physical value range enforced after transport's ratio recovery (the
    # signed-fragment remap is not convex at knife-edge denominators)
    lo: float = 0.0
    hi: float = float("inf")


# physical enthalpy floors (J/m^3)
_QICE_LO = -1.5e9
_QSNO_LO = -5.0e8


def tracer_registry(cfg) -> tuple[TracerSpec, ...]:
    """Active tracer table from the config (reference count_tracers)."""
    d, t = cfg.domain, cfg.tracers
    specs = [
        TracerSpec("Tsfcn", DEP_AICE, lo=-100.0, hi=0.0),
        TracerSpec("qice", DEP_VICE, d.nilyr, lo=_QICE_LO, hi=0.0),
        TracerSpec("sice", DEP_VICE, d.nilyr, hi=200.0),
        TracerSpec("qsno", DEP_VSNO, d.nslyr, lo=_QSNO_LO, hi=0.0),
    ]
    if t.tr_iage:
        specs.append(TracerSpec("iage", DEP_VICE))
    if t.tr_FY:
        specs.append(TracerSpec("FY", DEP_AICE, hi=1.0))
    if t.tr_lvl:
        specs.append(TracerSpec("alvl", DEP_AICE, hi=1.0))
        specs.append(TracerSpec("vlvl", DEP_VICE, hi=1.0))
    if t.tr_pond_lvl or t.tr_pond_topo or t.tr_pond_sealvl:
        # lvl ponds live on the level-ice fraction (trcr_depend(nt_apnd) =
        # 2+nt_alvl for tr_pond_lvl; plain area weight otherwise)
        apnd_parent = "alvl" if (t.tr_pond_lvl and t.tr_lvl) else None
        specs.append(TracerSpec("apnd", DEP_AICE, parent=apnd_parent, hi=1.0))
        specs.append(TracerSpec("hpnd", DEP_AICE, parent="apnd"))
        specs.append(TracerSpec("ipnd", DEP_AICE, parent="apnd"))
    if t.tr_snow:
        for nm in ("smice", "smliq", "rhos_cmp", "rsnw"):
            specs.append(TracerSpec(nm, DEP_VSNO, d.nslyr))
    if t.tr_fsd:
        specs.append(TracerSpec("fsd", DEP_AICE, d.nfsd, hi=1.0))
    if t.tr_iso and d.n_iso:
        specs.append(TracerSpec("isosno", DEP_AICE, d.n_iso))
        specs.append(TracerSpec("isoice", DEP_AICE, d.n_iso))
    if t.tr_aero and d.n_aero:
        specs.append(TracerSpec("aerosno", DEP_AICE, 2 * d.n_aero))
        specs.append(TracerSpec("aeroice", DEP_AICE, 2 * d.n_aero))
    if t.tr_brine:
        specs.append(TracerSpec("fbri", DEP_VICE))
    if getattr(cfg, "zbgc", None) is not None and cfg.zbgc.skl_bgc:
        z = cfg.zbgc
        if z.tr_bgc_N:
            specs.append(TracerSpec("bgc_N", DEP_AICE))
            if z.n_algae >= 2:
                specs.append(TracerSpec("bgc_N2", DEP_AICE))
            if z.n_algae >= 3:
                specs.append(TracerSpec("bgc_N3", DEP_AICE))
        if z.tr_bgc_Nit:
            specs.append(TracerSpec("bgc_Nit", DEP_AICE))
        if z.tr_bgc_Am:
            specs.append(TracerSpec("bgc_Am", DEP_AICE))
        if z.tr_bgc_Sil:
            specs.append(TracerSpec("bgc_Sil", DEP_AICE))
        if z.tr_bgc_DMS:
            specs.append(TracerSpec("bgc_DMSPp", DEP_AICE))
            specs.append(TracerSpec("bgc_DMSPd", DEP_AICE))
            specs.append(TracerSpec("bgc_DMS", DEP_AICE))
        if z.tr_bgc_PON:
            specs.append(TracerSpec("bgc_PON", DEP_AICE))
        if z.tr_bgc_DON:
            specs.append(TracerSpec("bgc_DON", DEP_AICE))
        if z.tr_bgc_C:
            for i in range(z.n_doc):
                specs.append(TracerSpec(f"bgc_DOC{i+1}", DEP_AICE))
            for i in range(z.n_dic):
                specs.append(TracerSpec(f"bgc_DIC{i+1}", DEP_AICE))
        if z.tr_bgc_Fe:
            specs.append(TracerSpec("bgc_Fed", DEP_AICE))
            specs.append(TracerSpec("bgc_Fep", DEP_AICE))
            if getattr(z, "n_fed", 1) >= 2:
                specs.append(TracerSpec("bgc_Fed2", DEP_AICE))
            if getattr(z, "n_fep", 1) >= 2:
                specs.append(TracerSpec("bgc_Fep2", DEP_AICE))
        if z.tr_bgc_hum:
            specs.append(TracerSpec("bgc_hum", DEP_AICE))
    if getattr(cfg, "zbgc", None) is not None and cfg.zbgc.z_tracers:
        # z tracers: bulk concentrations on the nblyr bio grid, conserved
        # per unit brine volume vice*fbri (trcr_depend = 2 + nt_fbri), each
        # with a mobile-fraction companion and a snow reservoir (content
        # per unit category area)
        from ..columns.zbgc_vertical import z_tracer_names
        nb = max(d.nblyr, 1)
        for nm in z_tracer_names(cfg.zbgc):
            specs.append(TracerSpec(nm, DEP_VICE, nb, parent="fbri"))
            specs.append(TracerSpec(nm + "_mf", DEP_VICE, nb, parent="fbri",
                                    hi=1.0))
            specs.append(TracerSpec(nm + "_sn", DEP_AICE))
    return tuple(specs)


#: the (ny, nx) and (4, ny, nx) tensor fields of State besides aicen,
#: vicen, vsnon and trcrn
STATE_PLANES = ("uvel", "vvel", "uvelE", "vvelE", "uvelN", "vvelN",
                "stressp", "stressm", "stress12", "a11", "a12", "sst",
                "frzmlt", "iceUmask", "mlt_onset", "frz_onset")


@dataclass(frozen=True)
class State:
    """Full prognostic state."""

    aicen: torch.Tensor        # (ncat, ny, nx) fractional area per category
    vicen: torch.Tensor        # ice volume per unit area (m)
    vsnon: torch.Tensor        # snow volume per unit area (m)
    trcrn: Dict[str, torch.Tensor]   # name -> (ncat[, nl], ny, nx)
    uvel: torch.Tensor         # B-grid ice velocity, x (m/s)
    vvel: torch.Tensor
    uvelE: torch.Tensor        # C-grid east-face u
    vvelE: torch.Tensor
    uvelN: torch.Tensor        # C-grid north-face v
    vvelN: torch.Tensor
    stressp: torch.Tensor      # (4, ny, nx) sigma11+sigma22 at NE,NW,SW,SE
    stressm: torch.Tensor      # sigma11-sigma22
    stress12: torch.Tensor     # sigma12
    a11: torch.Tensor          # (4, ny, nx) EAP structure tensor
    a12: torch.Tensor
    sst: torch.Tensor          # sea surface temperature (C)
    frzmlt: torch.Tensor       # freezing/melting potential (W/m^2)
    iceUmask: torch.Tensor     # bool (ny, nx): active momentum points
    mlt_onset: torch.Tensor
    frz_onset: torch.Tensor

    @property
    def aice(self) -> torch.Tensor:
        return self.aicen.sum(0)

    @property
    def vice(self) -> torch.Tensor:
        return self.vicen.sum(0)

    @property
    def vsno(self) -> torch.Tensor:
        return self.vsnon.sum(0)

    @property
    def aice0(self) -> torch.Tensor:
        return torch.clamp(1.0 - self.aice, 0.0, 1.0)

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


def zeros_state(cfg, grid) -> State:
    ny, nx = grid.ny_global, grid.nx_global
    ncat = cfg.domain.ncat
    kw = dict(dtype=cfg.np_dtype, device=grid.device)
    z2 = lambda: torch.zeros((ny, nx), **kw)
    zc = lambda: torch.zeros((ncat, ny, nx), **kw)
    trcrn = {}
    for spec in tracer_registry(cfg):
        if spec.nlayers:
            trcrn[spec.name] = torch.zeros((ncat, spec.nlayers, ny, nx), **kw)
        else:
            trcrn[spec.name] = torch.zeros((ncat, ny, nx), **kw)
    return State(
        aicen=zc(), vicen=zc(), vsnon=zc(), trcrn=trcrn,
        uvel=z2(), vvel=z2(), uvelE=z2(), vvelE=z2(), uvelN=z2(), vvelN=z2(),
        stressp=torch.zeros((4, ny, nx), **kw),
        stressm=torch.zeros((4, ny, nx), **kw),
        stress12=torch.zeros((4, ny, nx), **kw),
        a11=torch.full((4, ny, nx), 0.5, **kw),
        a12=torch.zeros((4, ny, nx), **kw),
        sst=z2(), frzmlt=z2(),
        iceUmask=torch.zeros((ny, nx), dtype=torch.bool, device=grid.device),
        mlt_onset=z2(), frz_onset=z2(),
    )


def state_leaves(state: State) -> list:
    """The state's tensors in the order `jax.tree.flatten` gives the JAX
    package's State (a registered dataclass): the fields in declaration
    order, the `trcrn` dict in sorted key order (capitals first). Restart
    files of both packages number their leaves so."""
    out = []
    for f in dataclasses.fields(State):
        v = getattr(state, f.name)
        if f.name == "trcrn":
            out += [v[k] for k in sorted(v)]
        else:
            out.append(v)
    return out


def state_from_leaves(template: State, leaves) -> State:
    """Inverse of `state_leaves`: a State with `template`'s tracers (in the
    template's key order) holding `leaves`."""
    leaves = list(leaves)
    n = len(dataclasses.fields(State)) - 1 + len(template.trcrn)
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a state of {n}")
    it = iter(leaves)
    kw = {}
    for f in dataclasses.fields(State):
        if f.name == "trcrn":
            got = {k: next(it) for k in sorted(template.trcrn)}
            kw["trcrn"] = {k: got[k] for k in template.trcrn}
        else:
            kw[f.name] = next(it)
    return State(**kw)
