"""Seeded smooth random fields on a grid: a coarse lattice of uniform
numbers, interpolated bilinearly onto (ny, nx). The same seed and stream
give the same field on every machine (NumPy's PCG64)."""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named stream of one seed."""
    tag = int.from_bytes(stream.encode(), "little") % (2 ** 61)
    return np.random.default_rng([int(seed) % (2 ** 64), tag])


def _weights(n: int, c: int) -> np.ndarray:
    """(n, c) linear interpolation weights from c lattice points onto n."""
    x = np.linspace(0.0, c - 1.0, n)
    i0 = np.minimum(np.floor(x).astype(int), c - 2)
    f = x - i0
    w = np.zeros((n, c))
    w[np.arange(n), i0] = 1.0 - f
    w[np.arange(n), i0 + 1] = f
    return w


def field(gen: np.random.Generator, shape, coarse=(9, 13),
          count: int = 1) -> np.ndarray:
    """`count` smooth fields in [0, 1] of `shape` (ny, nx), float64."""
    ny, nx = shape
    cy, cx = coarse
    lat = gen.random((count, cy, cx))
    return _weights(ny, cy) @ lat @ _weights(nx, cx).T
