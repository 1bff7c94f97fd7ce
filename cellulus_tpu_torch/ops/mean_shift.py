"""Mean-shift clustering with sklearn semantics, on the device.

Port of the default, monolithic path of ``cellulus_tpu/ops/mean_shift.py``
(``mean_shift_fit_predict`` through ``_fit_predict_kernel``):

- flat kernel, inclusive ball query (``dist <= bandwidth``),
- bin seeding (``get_bin_seeds`` at ``bin_size = bandwidth``) on the host,
- every seed iterates until its shift is below ``1e-3 * bandwidth`` (then it
  freezes, recording its ball population), its ball is empty, or
  ``max_iter``; a seed caught in an exact period-2 cycle jumps to the cycle
  phase it would hold at ``max_iter`` and halts,
- a recount of the never-frozen seeds, then sklearn's duplicate
  suppression: sort by (population, coordinates) descending, keep a center
  and drop every other within ``bandwidth``,
- nearest-center labels, ``-1`` beyond ``bandwidth`` of every center
  (``cluster_all=False``),
- fit on a ``reduction_probability`` subsample drawn on the host with numpy
  exactly as the JAX package draws it, predict on all points,
- given seeds (seeded mean shift) in place of bin seeds,
- a sweep of several bandwidths over one subsample draw
  (:func:`mean_shift_sweep_fit_predict`).

The fit and the recount are one call of
:func:`~cellulus_tpu_torch.ops.mean_shift_fit.mean_shift_fit`: on the card,
one kernel launch per clustering problem that loops on the device, with no
host check between iterations (the JAX package's single dispatch).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ball_stats import point_set
from .mean_shift_fit import mean_shift_fit
from ..utils.profiling import time_device


def bin_seeds(X: np.ndarray, bin_size: float, min_bin_freq: int = 1) -> np.ndarray:
    """sklearn ``get_bin_seeds``: occupied-grid-cell centers at ``bin_size``."""
    if bin_size == 0:
        return X
    binned = np.round(X / bin_size)
    uniq, counts = np.unique(binned, axis=0, return_counts=True)
    return (uniq[counts >= min_bin_freq] * bin_size).astype(X.dtype)


def _dedupe(centers, n_final, bw2: float):
    """sklearn duplicate suppression; return the kept centers ``(K, d)`` in
    sklearn's label order."""
    keep = (n_final > 0).cpu().numpy()
    c_np = centers.cpu().numpy()
    sort_counts = np.where(keep, n_final.cpu().numpy(), -1.0)
    d = c_np.shape[1]
    order = np.lexsort([-c_np[:, k] for k in reversed(range(d))] + [-sort_counts])
    sc = centers[torch.from_numpy(order).to(centers.device)]
    sq = (sc * sc).sum(dim=1)
    neighbor = ((sq[:, None] + sq[None, :] - 2.0 * (sc @ sc.T)) <= bw2).cpu().numpy()
    unique = keep[order].copy()
    for i in range(len(unique)):
        if unique[i]:
            unique[neighbor[i]] = False
            unique[i] = True
    return sc[torch.from_numpy(unique).to(centers.device)]


def _predict(X: torch.Tensor, centers: torch.Tensor, bw2: float) -> torch.Tensor:
    """Index of the nearest center per point, ``-1`` beyond the bandwidth."""
    labels = torch.full((X.shape[0],), -1, dtype=torch.int64, device=X.device)
    if centers.shape[0] == 0:
        return labels
    c_norm = (centers * centers).sum(dim=1)
    chunk = max(256, (1 << 24) // centers.shape[0])
    for start in range(0, X.shape[0], chunk):
        sl = X[start : start + chunk]
        d2 = (sl * sl).sum(dim=1)[:, None] + c_norm[None, :] - 2.0 * (sl @ centers.T)
        nearest = torch.argmin(d2, dim=1)
        best = torch.gather(d2, 1, nearest[:, None])[:, 0]
        labels[start : start + chunk] = torch.where(best <= bw2, nearest, -1)
    return labels


def fit_subsample(X: np.ndarray, reduction_probability: float,
                  rng: Optional[np.random.Generator]) -> np.ndarray:
    """The rows of ``X`` the fit runs on: a ``reduction_probability`` draw
    (all of ``X`` if the draw is empty), one ``rng.random(len(X))`` call."""
    if reduction_probability < 1.0:
        rng = rng or np.random.default_rng()
        X_fit = X[rng.random(len(X)) < reduction_probability]
        return X_fit if len(X_fit) else X
    return X


def fit_thresholds(bandwidth: float):
    """``(bw2, stop_thresh)`` as the JAX package computes them: in float32
    on the device."""
    bw = np.float32(bandwidth)
    return float(bw * bw), float(np.float32(1e-3) * bw)


def launch_fit(X_fit: torch.Tensor, seeds, bandwidth: float, max_iter: int):
    """The fit of ``seeds`` (host array or device tensor) on the device
    points ``X_fit``, launched without waiting for it: ``(centers,
    n_final)``."""
    dev = X_fit.device
    points = point_set(X_fit, torch.ones(len(X_fit), dtype=torch.bool, device=dev))
    bw2, stop_thresh = fit_thresholds(bandwidth)
    if isinstance(seeds, np.ndarray):
        seeds = torch.from_numpy(np.ascontiguousarray(seeds, dtype=np.float32)).to(dev)
    centers, n_final, _, _ = mean_shift_fit(seeds, points, bw2, stop_thresh, max_iter)
    return centers, n_final


def mean_shift_fit_predict(
    X: np.ndarray,
    bandwidth: float,
    seeds: Optional[np.ndarray],
    reduction_probability: float = 1.0,
    max_iter: int = 300,
    rng: Optional[np.random.Generator] = None,
    device="cuda:0",
) -> np.ndarray:
    """Fit on a subsample, predict labels for all rows of ``X``. ``seeds``:
    ``(S, d)`` given seeds, or None for bin seeds of the subsample.

    Returns int32 labels in ``[0, K)`` or ``-1`` for orphans.
    """
    X = np.asarray(X, dtype=np.float32)
    n, d = X.shape
    if n == 0:
        return np.zeros((0,), np.int32)
    X_fit = fit_subsample(X, reduction_probability, rng)
    if seeds is None:
        seeds = bin_seeds(X_fit, bin_size=bandwidth)
    if len(seeds) == 0:
        return np.full((n,), -1, np.int32)

    dev = torch.device(device)
    centers, n_final = time_device(
        "detect.device", launch_fit, torch.from_numpy(np.ascontiguousarray(X_fit)).to(dev),
        seeds, bandwidth, max_iter)
    bw2 = fit_thresholds(bandwidth)[0]
    kept = _dedupe(centers, n_final, bw2)
    labels = time_device("detect.device", _predict, torch.from_numpy(X).to(dev), kept, bw2)
    return labels.cpu().numpy().astype(np.int32)


def mean_shift_sweep_fit_predict(
    X: np.ndarray,
    bandwidths,
    reduction_probability: float = 1.0,
    max_iter: int = 300,
    rng: Optional[np.random.Generator] = None,
    device="cuda:0",
) -> np.ndarray:
    """Mean shift at each of K bandwidths over ONE fit subsample draw (the
    JAX package's ``mean_shift_sweep_fit_predict``; its results differ from
    K serial :func:`mean_shift_fit_predict` calls only by that shared draw).
    Every input is uploaded first (a copy from pageable host memory waits
    for the stream), then the K fits launch one after another on one stream
    with no host sync between them; then each is deduplicated and
    predicted. Returns ``(K, N)`` int32 labels."""
    X = np.asarray(X, dtype=np.float32)
    n, d = X.shape
    bandwidths = [float(b) for b in bandwidths]
    if n == 0:
        return np.zeros((len(bandwidths), 0), np.int32)
    X_fit = fit_subsample(X, reduction_probability, rng)
    dev = torch.device(device)
    X_fit_t = torch.from_numpy(np.ascontiguousarray(X_fit)).to(dev)
    X_t = torch.from_numpy(X).to(dev)
    seeds = [torch.from_numpy(bin_seeds(X_fit, bin_size=b)).to(dev) for b in bandwidths]
    fits = time_device("detect.device", lambda: [
        launch_fit(X_fit_t, s, b, max_iter) if len(s) else None
        for s, b in zip(seeds, bandwidths)])
    labels = np.full((len(bandwidths), n), -1, np.int32)
    for k, (b, fit) in enumerate(zip(bandwidths, fits)):
        if fit is not None:
            bw2 = fit_thresholds(b)[0]
            kept = _dedupe(*fit, bw2)
            labels[k] = time_device("detect.device", _predict, X_t, kept, bw2).cpu().numpy()
    return labels


def add_coordinate_grid(embedding_mean: np.ndarray) -> np.ndarray:
    """Offsets -> absolute embeddings: add the pixel-coordinate grid, x-first
    channel order (channel 0 = x = last spatial axis)."""
    out = np.array(embedding_mean, dtype=np.float32, copy=True)
    ndim = out.ndim - 1  # (D, *spatial)
    for channel in range(ndim):
        axis = ndim - 1 - channel
        shape = [1] * ndim
        shape[axis] = out.shape[1 + axis]
        out[channel] += np.arange(out.shape[1 + axis], dtype=np.float32).reshape(shape)
    return out


def mean_shift_segmentation(
    embedding_mean: np.ndarray,
    embedding_std: np.ndarray,
    bandwidth: float,
    reduction_probability: float,
    threshold: float,
    max_iter: int = 300,
    rng: Optional[np.random.Generator] = None,
    device="cuda:0",
    seeds: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Segment one sample's embeddings into instances.

    Args:
        embedding_mean: ``(1, D, *spatial)`` or ``(D, *spatial)`` offsets.
        embedding_std: ``(*spatial,)`` uncertainty channel.
        threshold: foreground threshold (std < threshold is foreground).
        seeds: optional ``(P, D)`` x-first seed coordinates (bin seeds of
            the fit subsample when None).

    Returns:
        ``(*spatial,)`` int32 labels; background and orphans are 0.
    """
    mean = np.asarray(embedding_mean, dtype=np.float32)
    if mean.ndim == embedding_std.ndim + 2:
        mean = mean[0]
    absolute = add_coordinate_grid(mean)
    mask = embedding_std < threshold
    if mask.sum() == 0:
        return np.zeros(mask.shape, dtype=np.int32)

    D = absolute.shape[0]
    X = absolute.reshape(D, -1).T[mask.ravel()]
    labels = mean_shift_fit_predict(
        X,
        bandwidth=bandwidth,
        seeds=seeds,
        reduction_probability=reduction_probability,
        max_iter=max_iter,
        rng=rng,
        device=device,
    )
    spatial = np.full(mask.shape, -1, np.int32)
    spatial[mask] = labels
    return spatial + 1
