"""Mushy-layer liquidus (the part of cice_tpu/columns/mushy.py that the
ocean freezing temperature needs; the mushy thermodynamics itself waits
for ROADMAP: column options)."""

from __future__ import annotations

import torch

AZ1_LIQ = 18.48
AZ2_LIQ = 10.3085
BZ2_LIQ = 62.4
T_JOIN = -BZ2_LIQ / (AZ1_LIQ - AZ2_LIQ)       # -7.636 C
S_JOIN = AZ1_LIQ * (-T_JOIN)                  # 141.1 g/kg


def liquidus_temperature(S: torch.Tensor) -> torch.Tensor:
    """Liquidus temperature T_liq(S) (degC); S in g/kg (>=0)."""
    Ss = torch.clamp(S, min=0.0)
    warm = Ss <= S_JOIN
    return torch.where(warm, -Ss / AZ1_LIQ, -(Ss - BZ2_LIQ) / AZ2_LIQ)
