"""Local-maximum peak detection and the seeds of seeded mean shift.

Port of ``cellulus_tpu/ops/peaks.py``. :func:`peak_local_max` is the scipy
oracle (skimage ``peak_local_max`` semantics with its defaults: a 3^d
maximum filter, a border of width 1 excluded, coordinates sorted by peak
intensity descending). :func:`smooth_peak_seeds` computes the seeds on the
device: a separable Gaussian in scipy's tap order, the peak mask of its
negation by a 3^d max filter with ``-inf`` borders, the border excluded;
only the ``argwhere`` and the stable intensity-descending sort run on the
host.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage as ndi

from ..utils.env import env_flag


def peak_local_max(image: np.ndarray, min_distance: int = 1) -> np.ndarray:
    """Return ``(P, ndim)`` integer peak coordinates (row-major order, i.e.
    (y, x) in 2D), intensity-descending."""
    size = 2 * min_distance + 1
    maxed = ndi.maximum_filter(image, size=size, mode="constant", cval=-np.inf)
    mask = image == maxed
    # exclude borders of width min_distance
    for d in range(image.ndim):
        sl = [slice(None)] * image.ndim
        sl[d] = slice(0, min_distance)
        mask[tuple(sl)] = False
        sl[d] = slice(image.shape[d] - min_distance, image.shape[d])
        mask[tuple(sl)] = False
    coords = np.argwhere(mask)
    if len(coords) == 0:
        return coords.astype(np.int64)
    values = image[tuple(coords.T)]
    order = np.argsort(-values, kind="stable")
    return coords[order]


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """scipy.ndimage's kernel: exp(-x^2/(2 sigma^2)) normalized to sum 1."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def smooth_and_peaks(image: torch.Tensor, sigma: float, min_distance: int):
    """``(smoothed, peak mask)`` of a 2D or 3D float32 field on its device:
    the Gaussian with scipy's ``truncate = 4`` radius and ``mode='reflect'``
    (numpy's ``symmetric`` padding), summed as scipy's ``correlate1d`` sums
    a symmetric kernel (centre tap first, then the paired taps outward),
    then the peaks of its negation."""
    ndim = image.dim()
    radius = int(4.0 * sigma + 0.5)
    weights = [float(w) for w in _gaussian_kernel1d(sigma, radius)]
    sm = image
    for ax in range(ndim):
        n = sm.shape[ax]
        idx = torch.from_numpy(np.pad(np.arange(n), radius, mode="symmetric")).to(image.device)
        p = sm.index_select(ax, idx)
        acc = weights[radius] * p.narrow(ax, radius, n)
        for k in range(1, radius + 1):
            acc = acc + weights[radius + k] * (
                p.narrow(ax, radius + k, n) + p.narrow(ax, radius - k, n))
        sm = acc
    neg = -sm
    size = 2 * min_distance + 1
    pool = F.max_pool2d if ndim == 2 else F.max_pool3d
    maxed = pool(neg[None, None], size, stride=1, padding=min_distance)[0, 0]
    mask = neg == maxed
    interior = torch.zeros_like(mask)
    interior[tuple(slice(min_distance, s - min_distance) for s in mask.shape)] = True
    return sm, mask & interior


def smooth_peak_seeds(
    offset_magnitude: np.ndarray, sigma: float = 2.0, min_distance: int = 1, device="cuda:0"
) -> np.ndarray:
    """Mean-shift seeds: ``(P, ndim)`` x-first float32 coordinates of the
    local minima of the Gaussian-smoothed offset magnitude,
    intensity-descending (``np.flip(peak_local_max(-gaussian_filter(x,
    sigma)), 1)``).

    Parity contract (the JAX package's): the peak coordinates equal the
    scipy oracle's exactly; the descending order may swap peaks whose
    smoothed values tie to the last bits, since the two sum in other
    orders. ``CELLULUS_TPU_CHECK_SEEDS=1`` cross-checks both against the
    oracle at run time and warns on a difference."""
    image = torch.from_numpy(np.ascontiguousarray(offset_magnitude, dtype=np.float32))
    sm, mask = smooth_and_peaks(image.to(device), float(sigma), int(min_distance))
    coords = np.argwhere(mask.cpu().numpy())
    if len(coords) == 0:
        return np.zeros((0, offset_magnitude.ndim), np.float32)
    values = -sm.cpu().numpy()[tuple(coords.T)]
    order = np.argsort(-values, kind="stable")
    result = np.flip(coords[order], 1).astype(np.float32)

    if env_flag("CELLULUS_TPU_CHECK_SEEDS"):
        expect = np.flip(peak_local_max(
            -ndi.gaussian_filter(np.asarray(offset_magnitude, np.float32), sigma),
            min_distance=min_distance), 1).astype(np.float32)
        same_set = result.shape == expect.shape and np.array_equal(
            np.asarray(sorted(map(tuple, result.tolist()))),
            np.asarray(sorted(map(tuple, expect.tolist()))),
        )
        if not same_set:
            warnings.warn(
                f"device seed COORDINATES diverged from the scipy oracle "
                f"({result.shape[0]} vs {expect.shape[0]} peaks) - labels "
                "may differ from the reference host path", RuntimeWarning)
        elif not np.array_equal(result, expect):
            n = int((result != expect).any(1).sum())
            warnings.warn(
                f"device seed ORDER swapped {n}/{len(result)} tied peaks vs the "
                "scipy oracle (coordinates exact; a summation-order effect)",
                RuntimeWarning)
    return result
