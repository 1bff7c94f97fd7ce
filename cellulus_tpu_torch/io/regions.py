"""Boundary-aware region reads shared by the training sampler and the
streaming tiled-inference scheduler."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def reflect_coords(start: int, size: int, extent: int) -> np.ndarray:
    """Absolute source indices for ``[start, start + size)`` under reflect
    boundary handling (no edge repetition: ``-1 -> 1``, ``extent -> extent-2``)."""
    idx = np.arange(start, start + size)
    if extent == 1:
        return np.zeros(size, dtype=np.int64)
    period = 2 * (extent - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= extent, period - idx, idx)


def read_reflect_region(
    read_fn,
    spatial: Sequence[int],
    origin: Sequence[int],
    size: Sequence[int],
    dtype=np.float32,
) -> np.ndarray:
    """Read ``(C, *size)`` at ``origin`` (spatial coords, may be negative or
    stick out past the extent), reflecting at the dataset boundary.

    Args:
        read_fn: ``read_fn(lo, hi) -> (C, *(hi - lo))`` for in-bounds
            ``lo``/``hi`` spatial corner tuples.
        spatial: full spatial extent.
    """
    coords = [
        reflect_coords(o, s, sp) for o, s, sp in zip(origin, size, spatial)
    ]
    lo = tuple(int(c.min()) for c in coords)
    hi = tuple(int(c.max()) + 1 for c in coords)
    data = np.asarray(read_fn(lo, hi), dtype=dtype)
    for d, (c, lo_d) in enumerate(zip(coords, lo)):
        # fast path: contiguous ascending coords are a plain slice
        if len(c) == (c[-1] - c[0] + 1) and np.all(np.diff(c) == 1):
            sl = [slice(None)] * data.ndim
            sl[1 + d] = slice(c[0] - lo_d, c[-1] - lo_d + 1)
            data = data[tuple(sl)]
        else:
            data = np.take(data, c - lo_d, axis=1 + d)
    return data
