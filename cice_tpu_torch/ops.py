"""Elementwise helpers that take tensors or Python scalars, as the array
functions of the JAX package do. A Python scalar stays a scalar all the way
into the PyTorch op (no 0-d tensor is built and uploaded), so it takes the
dtype of the tensor it meets, as a weakly typed JAX scalar does."""

from __future__ import annotations

import torch


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """min(max(x, lo), hi); each bound a tensor or a Python scalar
    (torch.clamp takes two tensors or two scalars, not one of each)."""
    x = torch.maximum(x, lo) if isinstance(lo, torch.Tensor) \
        else torch.clamp(x, min=lo)
    return torch.minimum(x, hi) if isinstance(hi, torch.Tensor) \
        else torch.clamp(x, max=hi)


def rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den for a Python scalar `num`, correctly rounded in den's
    dtype as JAX's `num / den` is (PyTorch's `num / den` computes
    `den.reciprocal() * num`, which differs in the last bit). The scalar
    rides as a 0-d CPU tensor: no upload."""
    return torch.div(torch.tensor(num, dtype=torch.float64), den)
