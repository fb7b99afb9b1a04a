"""Mushy-layer thermodynamics (ktherm=2): state relations and salinity
evolution (PyTorch port of cice_tpu/columns/mushy.py).

Turner, Hunke & Jeffery (2013): prognostic bulk salinity, piecewise-linear
liquidus, enthalpy of mush; Turner & Hunke (2015): the rapid
(Rayleigh-number-gated) and slow gravity drainage modes.

State per layer: bulk salinity S (g/kg, the `sice` tracer) and enthalpy q
(J/m^3, the `qice` tracer). Liquid (brine) fraction phi = S / S_br(T).
All functions are dense over arbitrary leading batch dims.
"""

from __future__ import annotations

import torch

from .. import constants as cst

# Piecewise-linear liquidus S_br(T) (g/kg, degC), two regions meeting at
# T_jn ~ -7.6 C: warm branch S=-a1 T, cold branch S = -a2 T + b2.
AZ1_LIQ = 18.48
AZ2_LIQ = 10.3085
BZ2_LIQ = 62.4
T_JOIN = -BZ2_LIQ / (AZ1_LIQ - AZ2_LIQ)       # -7.636 C
S_JOIN = AZ1_LIQ * (-T_JOIN)                  # 141.1 g/kg

CP_WATER = cst.cp_ocn      # brine heat capacity (J/kg/K)
RHO_WATER = cst.rhow       # brine density proxy

# Freitag (1999) permeability Pi = 3e-8 * phi^3 (m^2), gated by the
# percolation threshold phi_c = 0.05
PERM_A = 3.0e-8
PHI_PERC = 0.05
KAPPA_T = 1.2e-7           # thermal diffusivity of mush (m^2/s)
NU_BRINE = 1.8e-6          # kinematic viscosity of brine (m^2/s)
BETA_S = 7.5e-4            # haline density coefficient (1/(g/kg))
GRAV = 9.80616

# chimney-convection flux efficiency (Rees Jones & Worster 2014) and the
# reference brine-channel diameter (the default a_rapid_mode)
ALPHA_CONV = 0.03
A_CHANNEL_REF = 0.5e-3


def liquidus_brine_salinity(T: torch.Tensor) -> torch.Tensor:
    """Brine salinity on the liquidus S_br(T) (g/kg); T in degC (<=0)."""
    Tn = torch.clamp(T, max=-1e-6)
    warm = Tn >= T_JOIN
    return torch.where(warm, -AZ1_LIQ * Tn, -AZ2_LIQ * Tn + BZ2_LIQ)


def liquidus_temperature(S: torch.Tensor) -> torch.Tensor:
    """Liquidus temperature T_liq(S) (degC); S in g/kg (>=0)."""
    Ss = torch.clamp(S, min=0.0)
    warm = Ss <= S_JOIN
    return torch.where(warm, -Ss / AZ1_LIQ, -(Ss - BZ2_LIQ) / AZ2_LIQ)


def liquid_fraction(T, S):
    """Brine (liquid) volume fraction phi = S / S_br(T), in [0, 1]."""
    return torch.clamp(
        S / torch.clamp(liquidus_brine_salinity(T), min=1e-6), 0.0, 1.0)


def enthalpy_brine(T):
    return RHO_WATER * CP_WATER * T


def enthalpy_solid(T):
    return cst.rhoi * (cst.cp_ice * T - cst.Lfresh)


def enthalpy_mush(T, S):
    """Bulk enthalpy of mush q(T,S) (J/m^3); q=0 for fresh water at 0 C."""
    phi = liquid_fraction(T, S)
    return phi * enthalpy_brine(T) + (1.0 - phi) * enthalpy_solid(T)


def enthalpy_of_melting(S):
    """Energy to bring mush at the liquidus fully to liquid (J/m^3)."""
    return -enthalpy_mush(liquidus_temperature(S), S)


def temperature_mush(q, S):
    """Invert q(T,S) for T. Three regimes selected densely by enthalpy
    thresholds: fully liquid (q >= q_liq), mush warm branch, mush cold
    branch (each branch a quadratic in T because phi = S/(a|T|+b)). The
    negative root (-B - sqrt(disc)) / 2A with disc clamped at 0 is the JAX
    package's formula, kept as it is (it cancels in f32 near the
    liquidus, and so does the reference)."""
    Ss = torch.clamp(S, min=0.0)
    q_liq = enthalpy_brine(liquidus_temperature(Ss))
    T_liquid = q / (RHO_WATER * CP_WATER)

    def mush_T(a_liq, b_liq):
        # S_br(T) = -a_liq*T + b_liq ; phi = S/S_br
        A = cst.rhoi * cst.cp_ice * a_liq
        B = (-q * a_liq
             - Ss * RHO_WATER * CP_WATER
             + Ss * cst.rhoi * cst.cp_ice
             - cst.rhoi * cst.Lfresh * a_liq
             - cst.rhoi * cst.cp_ice * b_liq)
        C = (q * b_liq
             - Ss * cst.rhoi * cst.Lfresh
             + cst.rhoi * cst.Lfresh * b_liq)
        disc = torch.clamp(B * B - 4.0 * A * C, min=0.0)
        return (-B - torch.sqrt(disc)) / (2.0 * A)

    T_warm = mush_T(AZ1_LIQ, 0.0)
    T_cold = mush_T(AZ2_LIQ, BZ2_LIQ)
    # threshold: enthalpy of mush at the branch join temperature
    q_join = enthalpy_mush(torch.full_like(Ss, T_JOIN), Ss)
    T = torch.where(q >= q_liq, T_liquid,
                    torch.where(q >= q_join, T_warm, T_cold))
    return torch.clamp(T, max=0.0)


def conductivity_mush(T, S):
    """Thermal conductivity of mush: phi-weighted brine/ice blend."""
    phi = liquid_fraction(T, S)
    k_ice = 2.11 - 0.011 * torch.clamp(T, max=-0.1)
    return torch.clamp(phi * cst.kbrine + (1.0 - phi) * k_ice, min=cst.kimin)


def eff_heat_capacity_mush(T, T0, S):
    """Effective heat capacity c_eff = (1/rhoi) dq/dT (J/kg/K) for the
    implicit conduction solve: the exact dq/dT of the piecewise liquidus
    on the current branch. The temperature is held below -1e-3 C and the
    brine salinity above 1e-6, so no division goes to zero; the previous
    iterate T0 is not used (as in the JAX package)."""
    del T0
    Tn = torch.clamp(T, max=-1e-3)
    warm = Tn >= T_JOIN
    # (a tensor on one side: two Python scalars would give float32)
    a = torch.where(warm, AZ1_LIQ, torch.full_like(Tn, AZ2_LIQ))
    b = torch.where(warm, 0.0, torch.full_like(Tn, BZ2_LIQ))
    # phi = S/(-aT+b); dphi/dT = S*a/(-aT+b)^2 = phi*a/(-aT+b)
    Sbr = torch.clamp(-a * Tn + b, min=1e-6)
    phi = torch.clamp(S / Sbr, 0.0, 1.0)
    dphi = phi * a / Sbr
    dq = (dphi * (enthalpy_brine(Tn) - enthalpy_solid(Tn))
          + phi * RHO_WATER * CP_WATER
          + (1.0 - phi) * cst.rhoi * cst.cp_ice)
    return torch.clamp(dq / cst.rhoi, min=0.1 * cst.cp_ice)


def new_ice_enthalpy_salinity(Tbot, sss, phi_init):
    """Enthalpy and bulk salinity of new congelation ice at Tbot with
    liquid fraction 1 - phi_init (phi_i_mushy is the solid fraction)."""
    del sss
    phi_l = min(max(1.0 - phi_init, 0.02), 0.98)
    Sbr = liquidus_brine_salinity(Tbot)
    S_new = phi_l * Sbr
    q_new = (phi_l * enthalpy_brine(Tbot) +
             (1.0 - phi_l) * enthalpy_solid(Tbot))
    return q_new, S_new


def drain_salinity(cfg_th, dt, *, S_layers, T_layers, hilyr, sss, nilyr):
    """Two-mode gravity drainage of the mushy layer (Turner, Hunke &
    Elliott 2013).

    Rapid mode: the Rayleigh number of layer k is measured from its
    midpoint to the base with the smallest permeability of the layers at
    and below it (the flow bottleneck, a running minimum from the base
    upward); above Rac the Darcy flushing velocity grows linearly in the
    supercriticality. Slow mode: where the mush stays permeable
    (phi > phi_c_slow_mode) the brine drains at |dSdt_slow_mode|. Pore
    flushing relaxes S toward phi*sss with the exponential update
    1 - exp(-w dt / dz), monotone for any w.

    Returns (new S layers list, fsalt_drain [kg/m^2/s to the ocean])."""
    phi_l = [liquid_fraction(T_layers[k], S_layers[k]) for k in range(nilyr)]
    perm = [PERM_A * (torch.clamp(phi_l[k] - PHI_PERC, min=0.0) /
                      (1.0 - PHI_PERC)) ** 3 for k in range(nilyr)]
    perm_min = [None] * nilyr
    running = perm[nilyr - 1]
    for k in range(nilyr - 1, -1, -1):
        running = torch.minimum(running, perm[k])
        perm_min[k] = running

    geom = (cfg_th.a_rapid_mode / A_CHANNEL_REF) ** 2 / \
        max(cfg_th.aspect_rapid_mode, 1e-8) ** 2
    w_slow0 = abs(cfg_th.dSdt_slow_mode)

    fsalt = torch.zeros_like(S_layers[0])
    S_out = []
    dz = torch.clamp(hilyr, min=1e-6)
    for k in range(nilyr):
        S = S_layers[k]
        phi = phi_l[k]
        Sbr = liquidus_brine_salinity(T_layers[k])
        L = torch.clamp(hilyr * (nilyr - k - 0.5), min=1e-6)  # midpoint->base
        Ra = (GRAV * BETA_S * torch.clamp(Sbr - sss, min=0.0) * perm_min[k]
              * L / (KAPPA_T * NU_BRINE))
        super_c = torch.clamp(Ra - cfg_th.Rac_rapid_mode, min=0.0)
        w_rapid = ALPHA_CONV * geom * KAPPA_T * super_c / L
        slow_on = ((phi > cfg_th.phi_c_slow_mode) & (Sbr > sss)).to(S.dtype)
        w = w_rapid + w_slow0 * slow_on
        f_flush = 1.0 - torch.exp(-w * dt / dz)
        dS = f_flush * torch.clamp(S - phi * sss, min=0.0)
        S_out.append(S - dS)
        fsalt = fsalt + dS * 1e-3 * cst.rhoi * hilyr / dt
    return S_out, fsalt
