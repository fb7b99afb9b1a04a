"""Ocean freezing temperature (the `freezing_temperature` part of
cice_tpu/columns/ocean.py; the slab mixed layer comes with ROADMAP:
slice 2)."""

from __future__ import annotations

import torch

from .. import constants as cst


def freezing_temperature(sss: torch.Tensor,
                         option: str = "mushy") -> torch.Tensor:
    """Tf(SSS) (degC). 'minus1p8'/'constant': -1.8; 'linear_salt':
    -depressT*S; 'mushy': the piecewise-linear mushy liquidus."""
    if option in ("minus1p8", "constant"):
        return torch.full_like(sss, -1.8)
    if option == "linear_salt":
        return -cst.depressT * sss
    from .mushy import liquidus_temperature
    return liquidus_temperature(sss)
