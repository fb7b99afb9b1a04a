"""Elementwise helpers that take tensors or Python scalars, as the array
functions of the JAX package do. A Python scalar stays a scalar all the way
into the PyTorch op (no 0-d tensor is built and uploaded), so it takes the
dtype of the tensor it meets, as a weakly typed JAX scalar does.

`lsum` and `lmean` reduce over a leading dimension (categories, layers,
bands) in one fixed order, elementwise, so that a tile of a sharded grid
gets the bits of the whole grid's result."""

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


def lsum(x: torch.Tensor, dim: int = 0, keepdim: bool = False
         ) -> torch.Tensor:
    """x summed over the leading dimension `dim` as x[0] + x[1] + ... in
    that order, elementwise: the same bits for any extent of the trailing
    (grid) dimensions, on any device. PyTorch's reductions choose their
    order by shape (on the CPU the 5 rows of a (5, 24, 10) float32 tensor
    add up otherwise than those of a (5, 48, 40) one), which would set a
    tile of a sharded state apart from the whole grid."""
    d = dim % x.ndim
    if x.shape[d] == 0:
        out = x.sum(d)
    else:
        out = x.select(d, 0)
        for k in range(1, x.shape[d]):
            out = out + x.select(d, k)
        if x.shape[d] == 1:
            out = out.clone()
    return out.unsqueeze(d) if keepdim else out


def lmean(x: torch.Tensor, dim: int = 0, keepdim: bool = False
          ) -> torch.Tensor:
    """`lsum` over `dim` divided by its extent."""
    return lsum(x, dim, keepdim) / x.shape[dim]
