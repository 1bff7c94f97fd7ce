"""Otsu thresholding (skimage ``threshold_otsu`` semantics, 256 bins).

A copy of the numpy ``threshold_otsu`` of ``cellulus_tpu/ops/otsu.py``:
the detect stage thresholds the uncertainty channel on the host, as the
JAX package's default detect path does.
"""

from __future__ import annotations

import numpy as np


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
