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
  exactly as the JAX package draws it, predict on all points.

Every fit iteration and the recount go through
:func:`~cellulus_tpu_torch.ops.ball_stats.ball_stats` (the CUDA kernel on
the card). The fit loop is a Python loop with one device-to-host check of
``halted.all()`` per iteration.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ball_stats import ball_stats, point_set


def bin_seeds(X: np.ndarray, bin_size: float, min_bin_freq: int = 1) -> np.ndarray:
    """sklearn ``get_bin_seeds``: occupied-grid-cell centers at ``bin_size``."""
    if bin_size == 0:
        return X
    binned = np.round(X / bin_size)
    uniq, counts = np.unique(binned, axis=0, return_counts=True)
    return (uniq[counts >= min_bin_freq] * bin_size).astype(X.dtype)


def _fit(points, seeds: torch.Tensor, bw2: float, stop_thresh: float, max_iter: int):
    """Iterate all seeds; return ``(centers, n_final, frozen)``."""
    S = seeds.shape[0]
    dev = seeds.device
    centers = seeds
    prev = torch.full_like(seeds, float("inf"))
    n_final = torch.zeros((S,), dtype=torch.float32, device=dev)
    frozen = torch.zeros((S,), dtype=torch.bool, device=dev)
    halted = frozen.clone()
    it = 0
    while it < max_iter and not bool(halted.all()):
        counts, sums = ball_stats(centers, points, bw2)
        means = sums / torch.clamp(counts, min=1.0)[:, None]
        empty = counts == 0
        shift = torch.linalg.vector_norm(means - centers, dim=1)
        newly_done = empty | (shift < stop_thresh)
        new_centers = torch.where((halted | empty)[:, None], centers, means)
        # exact period-2 cycle: the trajectory repeats, so move the seed to
        # the phase it would hold after the remaining iterations and halt it
        cycle = (new_centers == prev).all(dim=1) & ~halted & ~newly_done
        final_pos = new_centers if (max_iter - (it + 1)) % 2 == 0 else centers
        new_centers = torch.where(cycle[:, None], final_pos, new_centers)
        n_final = torch.where(frozen, n_final, counts)
        frozen = frozen | newly_done
        halted = halted | newly_done | cycle
        prev, centers = centers, new_centers
        it += 1
    return centers, n_final, frozen


def _dedupe(points, centers, n_final, frozen, bw2: float):
    """Recount + sklearn duplicate suppression; return the kept centers
    ``(K, d)`` in sklearn's label order."""
    counts, _ = ball_stats(centers, points, bw2)
    n_final = torch.where(frozen, n_final, counts)
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


def mean_shift_fit_predict(
    X: np.ndarray,
    bandwidth: float,
    seeds: Optional[np.ndarray],
    reduction_probability: float = 1.0,
    max_iter: int = 300,
    rng: Optional[np.random.Generator] = None,
    device="cuda:0",
) -> np.ndarray:
    """Fit on a subsample, predict labels for all rows of ``X``.

    Returns int32 labels in ``[0, K)`` or ``-1`` for orphans.
    """
    X = np.asarray(X, dtype=np.float32)
    n, d = X.shape
    if n == 0:
        return np.zeros((0,), np.int32)

    if reduction_probability < 1.0:
        rng = rng or np.random.default_rng()
        X_fit = X[rng.random(n) < reduction_probability]
        if len(X_fit) == 0:
            X_fit = X
    else:
        X_fit = X

    if seeds is None:
        seeds = bin_seeds(X_fit, bin_size=bandwidth)
    seeds = np.asarray(seeds, dtype=np.float32)
    if len(seeds) == 0:
        return np.full((n,), -1, np.int32)

    # the JAX package computes both in float32 on the device
    bw = np.float32(bandwidth)
    bw2 = float(bw * bw)
    stop_thresh = float(np.float32(1e-3) * bw)

    dev = torch.device(device)
    X_fit_t = torch.from_numpy(np.ascontiguousarray(X_fit)).to(dev)
    points = point_set(X_fit_t, torch.ones(len(X_fit), dtype=torch.bool, device=dev))
    centers, n_final, frozen = _fit(
        points, torch.from_numpy(seeds).to(dev), bw2, stop_thresh, max_iter
    )
    kept = _dedupe(points, centers, n_final, frozen, bw2)
    labels = _predict(torch.from_numpy(X).to(dev), kept, bw2)
    return labels.cpu().numpy().astype(np.int32)


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
) -> np.ndarray:
    """Segment one sample's embeddings into instances.

    Args:
        embedding_mean: ``(1, D, *spatial)`` or ``(D, *spatial)`` offsets.
        embedding_std: ``(*spatial,)`` uncertainty channel.
        threshold: foreground threshold (std < threshold is foreground).

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
        seeds=None,
        reduction_probability=reduction_probability,
        max_iter=max_iter,
        rng=rng,
        device=device,
    )
    spatial = np.full(mask.shape, -1, np.int32)
    spatial[mask] = labels
    return spatial + 1
