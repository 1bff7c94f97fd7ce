"""Otsu thresholding (skimage ``threshold_otsu`` semantics, 256 bins) and
the quantile threshold.

Copies of ``cellulus_tpu/ops/otsu.py``: the numpy ``threshold_otsu`` with
which the default detect path thresholds the uncertainty channel on the
host, and ``threshold_otsu_jax`` in torch for the device-resident detect;
beside them the device quantile of that path (``jnp.quantile``).
"""

from __future__ import annotations

import numpy as np
import torch


def threshold_otsu(image: np.ndarray, nbins: int = 256) -> float:
    image = np.asarray(image).ravel()
    counts, edges = np.histogram(image, bins=nbins)
    centers = (edges[:-1] + edges[1:]) / 2
    counts = counts.astype(np.float64)

    w1 = np.cumsum(counts)
    w2 = np.cumsum(counts[::-1])[::-1]
    m1 = np.cumsum(counts * centers) / np.maximum(w1, 1e-12)
    m2 = (np.cumsum((counts * centers)[::-1]) / np.maximum(w2[::-1], 1e-12))[::-1]
    variance12 = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    idx = int(np.argmax(variance12))
    return float(centers[idx])


def threshold_otsu_device(image: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Otsu on the device, the JAX package's ``threshold_otsu_jax`` in
    torch: a 256-bin histogram over ``[min, max]`` (bins by truncation of
    ``(x - lo) / span * nbins``), float32 throughout; a 0-d tensor."""
    flat = image.reshape(-1).float()
    lo, hi = flat.min(), flat.max()
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    idx = torch.clamp(((flat - lo) / span * nbins).to(torch.int32), 0, nbins - 1)
    counts = torch.bincount(idx, minlength=nbins).float()
    steps = torch.arange(nbins + 1, dtype=torch.float32, device=flat.device)
    edges = lo + span * steps / nbins
    centers = (edges[:-1] + edges[1:]) / 2
    w1 = torch.cumsum(counts, 0)
    w2 = torch.cumsum(counts.flip(0), 0).flip(0)
    m1 = torch.cumsum(counts * centers, 0) / torch.clamp(w1, min=1e-12)
    m2 = (torch.cumsum((counts * centers).flip(0), 0)
          / torch.clamp(w2.flip(0), min=1e-12)).flip(0)
    variance12 = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    return centers[torch.argmax(variance12)]


def quantile_device(values: torch.Tensor, q: float) -> float:
    """``jnp.quantile(values, q)`` (linear interpolation) for a float32
    tensor of any size (``torch.quantile`` refuses more than 2^24 values):
    a sort on the device, then the interpolation in float32 as the JAX
    package's compiled quantile computes it: ``q * (n - 1)``, its floor and
    ceiling and their weights, and the high term added to the rounded low
    term in one fused multiply-add. NaN if any value is NaN."""
    flat = values.reshape(-1).float()
    if bool(torch.isnan(flat).any()):
        return float("nan")
    q = np.float32(q)
    n = np.float32(flat.numel())
    pos = q * (n - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    high_weight = pos - low
    low_weight = np.float32(1) - high_weight
    low = int(np.clip(low, 0, n - 1))
    high = int(np.clip(high, 0, n - 1))
    ordered = torch.sort(flat).values
    low_value, high_value = (np.float32(v) for v in ordered[[low, high]].cpu().numpy())
    # a float32 product is exact in float64, so this rounds once, as an FMA
    return float(np.float32(np.float64(high_value) * np.float64(high_weight)
                            + np.float64(low_value * low_weight)))
