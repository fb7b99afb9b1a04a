"""Coupler import/export surface (PyTorch port of
cice_tpu/model/coupling.py; the reference's coupled-driver exchange layer,
drivers/nuopc/cmeps/ice_import_export.F90, and `scale_fluxes` in
general/ice_flux.F90). A host earth-system model embeds the ice with:

    ice = CoupledIce(cfg)                    # device="cuda" by default
    ice.import_fields({"Sa_z": ..., "Sa_tbot": ..., ...})   # per step
    ice.step()
    out = ice.export_fields()    # {"Si_ifrac": ..., "Faii_sen": ...}
    host = convert.exports_to_numpy(out)     # for a host coupler

Field names follow the CMEPS/CESM convention of the reference's nuopc cap.
Imports may be numpy arrays or tensors; each moves to the model's device
and dtype once. Exports stay on the device. Fluxes are exported per unit
ice area when `scale_fluxes=True` (the reference's scale_fluxes divides by
aice for the coupler).

The coupler is the forcing: `step()` runs `model_step` on the imported
Forcing and never calls the model's own atmosphere or ocean forcing (the
JAX package's coupled step does, and its box2001 winds or file forcing
then overwrite the imports). The step stamps only the ice's own calendar
day (`yday`) and solar zenith (`coszen`, from the configured orbit). A
Forcing field that no coupler field sets keeps its value from the model's
initial forcing (zeros_forcing and default_ocn). Imported `So_s` sets the
freezing point `Tf` under `thermo.tfrz_option`, and `Sa_u`/`Sa_v` the wind
speed.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import constants as cst
from ..ops import lsum
from ..columns.ocean import freezing_temperature
from .driver import Model
from .forcing import default_coszen

# coupler name -> Forcing attribute ('frzmlt_in': the state's frzmlt)
IMPORT_MAP = {
    "Sa_u": "uatm", "Sa_v": "vatm", "Sa_z": "zlvl",
    "Sa_tbot": "Tair", "Sa_ptem": "potT", "Sa_shum": "Qa",
    "Sa_dens": "rhoa", "Sa_pbot": "pbot",
    "Faxa_lwdn": "flw", "Faxa_rain": "frain", "Faxa_snow": "fsnow",
    "Faxa_swvdr": "swvdr", "Faxa_swvdf": "swvdf",
    "Faxa_swndr": "swidr", "Faxa_swndf": "swidf",
    "So_u": "uocn", "So_v": "vocn", "So_s": "sss", "So_t": "sst_data",
    "So_dhdx": "ss_tltx", "So_dhdy": "ss_tlty",
    "Fioo_q": "frzmlt_in", "So_hmix": "hmix",
}

# aerosol deposition routing (ice_import_export.F90 import of
# Faxa_bcph(3)/Faxa_dstwet(4)/Faxa_dstdry(4) into faero_atm): species 1 =
# hydrophobic BC (dry + first bcph class), 2 = hydrophilic BC, 3 = total
# dust.
AEROSOL_IMPORTS = ("Faxa_bcph", "Faxa_dstwet", "Faxa_dstdry")

# water-isotope coupling surface (ice_import_export.F90:739-770 imports,
# :1300-1340 exports): species order HDO / H2_16O / H2_18O
WISO_IMPORTS = ("Sa_shum_wiso", "Faxa_snow_wiso", "So_roce_wiso")

#: every coupler field `import_fields` reads
IMPORTS = frozenset(IMPORT_MAP) | frozenset(AEROSOL_IMPORTS) | frozenset(
    WISO_IMPORTS) | {"Sw_elevation_spectrum"}


class CoupledIce:
    """Subroutine-call coupling wrapper (the direct/hadgem3-style driver:
    the same Initialize/Run/Finalize triple, arrays exchanged)."""

    def __init__(self, cfg, scale_fluxes: bool = True, device="cuda"):
        self.model = Model(cfg, device=device)
        self.scale_fluxes = scale_fluxes
        # water-isotope coupling state (imported, read at export time)
        self.Qa_iso = None       # (3, ny, nx) Sa_shum_wiso
        self.roce_iso = None     # (3, ny, nx) So_roce_wiso ocean ratios

    def _t(self, arr) -> torch.Tensor:
        m = self.model
        return torch.as_tensor(arr, dtype=m.cfg.np_dtype, device=m.device)

    # -- import (coupler -> ice) -----------------------------------------
    def import_fields(self, fields: Dict[str, object]):
        """Set the model's Forcing (and `Fioo_q` the state's frzmlt) from
        coupler fields; names outside the surface are ignored."""
        m = self.model
        f = {k: self._t(v) for k, v in fields.items() if k in IMPORTS}
        shp = m.grid.shape
        upd = {attr: f[c] for c, attr in IMPORT_MAP.items()
               if c in f and attr != "frzmlt_in"}
        if "Sa_u" in f and "Sa_v" in f:
            upd["wind"] = torch.sqrt(f["Sa_u"] ** 2 + f["Sa_v"] ** 2)
        if "So_s" in f:
            upd["Tf"] = freezing_temperature(f["So_s"],
                                             m.cfg.thermo.tfrz_option)
        if any(k in f for k in AEROSOL_IMPORTS):
            z = torch.zeros(shp, dtype=m.cfg.np_dtype, device=m.device)

            def vec(key, n):
                return f[key] if key in f else z.expand((n,) + shp)
            bcph = vec("Faxa_bcph", 3)
            dst = vec("Faxa_dstwet", 4) + vec("Faxa_dstdry", 4)
            n_aero = m.cfg.domain.n_aero
            species = [bcph[0] + (bcph[1] if bcph.shape[0] > 1 else z),
                       bcph[2] if bcph.shape[0] > 2 else z, lsum(dst)]
            upd["faero_atm"] = (torch.stack((species + [z] * n_aero)[:n_aero])
                                if n_aero else z.new_zeros((0,) + shp))
        if "Faxa_snow_wiso" in f:
            # snowfall isotopes feed the deposition pathway
            n_iso = m.cfg.domain.n_iso
            if n_iso and f["Faxa_snow_wiso"].shape[0] >= n_iso:
                upd["fiso_atm"] = f["Faxa_snow_wiso"][:n_iso]
        if "Sw_elevation_spectrum" in f:
            # a wave model's elevation spectrum (the FSD's fracture)
            upd["wave_spectrum"] = f["Sw_elevation_spectrum"]
        if "Sa_shum_wiso" in f:
            self.Qa_iso = f["Sa_shum_wiso"]
        if "So_roce_wiso" in f:
            self.roce_iso = f["So_roce_wiso"]
        m.forcing = m.forcing.replace(**upd)
        if "Fioo_q" in f:
            m.state = m.state.replace(frzmlt=f["Fioo_q"])

    def coupled_forcing(self):
        """The Forcing the next coupled step hands `model_step`: the
        imported fields with the ice's calendar day and solar zenith."""
        m = self.model
        fc = m.forcing
        yday = m.calendar.fyday
        coszen, _ = default_coszen(m.grid, yday, cfg=m.cfg)
        return fc.replace(coszen=coszen.to(fc.coszen.dtype),
                          yday=torch.tensor(yday, dtype=fc.wind.dtype,
                                            device=fc.wind.device))

    def step(self):
        """One coupled step on the imported Forcing."""
        self.model.step(forcing=self.coupled_forcing())

    def run(self, nsteps: int):
        """`nsteps` coupled steps on the same imports (the calendar moves,
        so each step stamps its own day and zenith), then the final dump
        if `setup.dump_last` and the writer's flush."""
        m = self.model
        for _ in range(nsteps):
            self.step()
        if m.cfg.setup.dump_last:
            m.write_restart()
        m.flush_io()

    # -- export (ice -> coupler) -----------------------------------------
    def export_fields(self) -> Dict[str, torch.Tensor]:
        """The ice's exports, on the model's device."""
        st = self.model.state
        fl = self.model.flux
        aice = st.aice
        ai = torch.clamp(aice, min=cst.puny)
        has = aice > cst.puny
        zero = torch.zeros((), dtype=aice.dtype, device=aice.device)

        def per_ice(x):
            return torch.where(has, x / ai, zero)
        s = per_ice if self.scale_fluxes else (lambda x: x)
        out = {
            # states
            "Si_ifrac": aice,
            "Si_imask": (self.model.grid.hm > 0.5).to(aice.dtype),
            "Si_thick": per_ice(st.vice),
            "Si_snowh": per_ice(st.vsno),
            "Si_u10": st.uvel, "Si_v10": st.vvel,
            "Si_t": lsum(st.trcrn["Tsfcn"] * st.aicen) / ai + cst.Tffresh,
            "Si_avsdr": s(fl.alvdr) if fl else aice * 0,
            "Si_avsdf": s(fl.alvdf) if fl else aice * 0,
            "Si_anidr": s(fl.alidr) if fl else aice * 0,
            "Si_anidf": s(fl.alidf) if fl else aice * 0,
            # beyond the core set (ice_import_export.F90 export list):
            # total volumes, per-category fractions
            "Si_vice": st.vice, "Si_vsno": st.vsno, "Si_ifrac_n": st.aicen,
        }
        if fl is not None:
            out.update({"Si_tref": fl.Tref, "Si_qref": fl.Qref,
                        "Si_u10": fl.Uref})
        if "fsd" in st.trcrn:
            from ..columns.fsd import fsd_bounds
            nfsd = st.trcrn["fsd"].shape[1]
            mid = torch.as_tensor(fsd_bounds(nfsd)[2], dtype=aice.dtype,
                                  device=aice.device)[None, :, None, None]
            rmean = lsum(st.trcrn["fsd"] * mid, dim=1)
            out["Si_floediam"] = 2.0 * torch.clamp(
                lsum(rmean * st.aicen) / ai, min=8.0)
        else:
            # a constant representative diameter without the FSD (the
            # reference's floediam default)
            out["Si_floediam"] = torch.full_like(aice, 300.0)
        if fl is None:
            return out
        out.update({
            # atmosphere fluxes (per ice area when scaled)
            "Faii_sen": s(fl.fsens), "Faii_lat": s(fl.flat),
            "Faii_lwup": s(fl.flwout), "Faii_evap": s(fl.evap),
            "Faii_swnet": s(fl.fswabs),
            "Faii_taux": s(fl.strairx), "Faii_tauy": s(fl.strairy),
            # ocean fluxes
            "Fioi_melth": fl.fhocn, "Fioi_meltw": fl.fresh,
            "Fioi_salt": fl.fsalt, "Fioi_swpen": fl.fswthru,
            "Fioi_taux": fl.strocnx, "Fioi_tauy": fl.strocny,
        })
        faero = fl.ncat_fluxes.get("faero_ocn")
        if faero is not None and faero.shape[0] >= 3:
            out.update({"Fioi_bcpho": faero[0], "Fioi_bcphi": faero[1],
                        "Fioi_flxdst": faero[2]})
        # per-band and per-category shortwave penetration
        # (ice_import_export.F90:1218-1245, :262). CCSM3 semantics: only
        # the visible bands penetrate the ice, so the band split follows
        # the incident visible partition; the near-IR exports are zero
        fc = self.model.forcing
        vis = fc.swvdr + fc.swvdf
        wdr = torch.where(vis > cst.puny,
                          fc.swvdr / torch.clamp(vis, min=cst.puny),
                          torch.full_like(vis, 0.5))
        out["Fioi_swpen_vdr"] = fl.fswthru * wdr
        out["Fioi_swpen_vdf"] = fl.fswthru * (1.0 - wdr)
        out["Fioi_swpen_idr"] = torch.zeros_like(fl.fswthru)
        out["Fioi_swpen_idf"] = torch.zeros_like(fl.fswthru)
        swn = fl.ncat_fluxes.get("fswthrun")
        if swn is not None:
            out["Fioi_swpen_ifrac_n"] = swn
        # water-isotope exports (ice_import_export.F90:1300-1340): meltwater
        # carries the per-species ocean release; sublimation does not
        # fractionate, so evaporation carries the snow's isotope ratio
        fiso = fl.ncat_fluxes.get("fiso_ocn")
        if fiso is not None and fiso.shape[0] > 0:
            out["Fioi_meltw_wiso"] = fiso
            trc = st.trcrn
            if "isosno" in trc:
                # isosno is a burden per category area (aero_iso.py)
                snow_mass = cst.rhos * torch.clamp(st.vsno, min=cst.puny)
                R = torch.stack([
                    lsum(trc["isosno"][:, k] * st.aicen, dim=0)
                    / snow_mass for k in range(fiso.shape[0])])
                out["Faii_evap_wiso"] = fl.evap[None] * R
            if self.Qa_iso is not None:
                # reference-height humidity isotopes relax to the imported
                # atmospheric ratio
                out["Si_qref_wiso"] = self.Qa_iso
        return out
