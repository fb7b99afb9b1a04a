"""The mushy-layer state relations that the brine height and the z
tracers read (a frozen copy of the program's columns/mushy.py, cut to the
liquidus, the liquid fraction, the enthalpies and the temperature
inversion).

Turner, Hunke & Jeffery (2013): piecewise-linear liquidus, enthalpy of
mush. Liquid (brine) fraction phi = S / S_br(T). All functions are dense
over arbitrary leading batch dims.
"""

from __future__ import annotations

import torch

from ...ice import constants as cst

# Piecewise-linear liquidus S_br(T) (g/kg, degC), two regions meeting at
# T_jn ~ -7.6 C: warm branch S=-a1 T, cold branch S = -a2 T + b2.
AZ1_LIQ = 18.48
AZ2_LIQ = 10.3085
BZ2_LIQ = 62.4
T_JOIN = -BZ2_LIQ / (AZ1_LIQ - AZ2_LIQ)       # -7.636 C
S_JOIN = AZ1_LIQ * (-T_JOIN)                  # 141.1 g/kg

CP_WATER = cst.cp_ocn      # brine heat capacity (J/kg/K)
RHO_WATER = cst.rhow       # brine density proxy


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
