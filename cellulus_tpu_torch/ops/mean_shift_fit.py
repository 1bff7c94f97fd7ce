"""The mean-shift fit: every seed iterated to its end, then the recount.

:func:`mean_shift_fit` computes what ``cellulus_tpu/ops/mean_shift.py``
computes in ``_fit_impl`` (a ``jax.lax.while_loop`` of ``_make_step``) and in
the recount of ``_finalize_impl``: each seed moves to the mean of the valid
points within the bandwidth until its shift is below ``stop_thresh`` (it
freezes, recording its ball population), its ball is empty (it freezes at
population 0), an exact period-2 cycle halts it at the phase it would hold at
``max_iter``, or ``max_iter`` ends the loop; the seeds that never froze then
record their population at their final position.

On CUDA tensors it launches ``mean_shift_fit_kernel`` of
``csrc/ball_stats.cu`` once for the whole fit (design, bound and the order of
its sums in the source's header); on CPU tensors it runs
:func:`mean_shift_fit_plain`, a loop over a ball-statistics function.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import kernels
from .ball_stats import _SIGNATURES, MAX_DIM, PointSet, ball_stats_plain

# the launch shape the kernel is compiled for; a seed's sums depend on it
# (and on N), never on the number of seeds
FIT_CLUSTER = 8
FIT_THREADS = 256


def mean_shift_fit_plain(
    seeds: torch.Tensor,
    points: PointSet,
    bw2: float,
    stop_thresh: float,
    max_iter: int,
    ball_stats_fn=ball_stats_plain,
):
    """One global loop over all seeds, ``ball_stats_fn(centers, points, bw2)``
    each iteration, then the recount. Returns ``(centers (S, d), n_final (S,),
    frozen (S,) bool, n_iter (S,) int32)``; ``n_iter`` counts the iterations
    a seed was live."""
    S = seeds.shape[0]
    dev = seeds.device
    centers = seeds.float()
    prev = torch.full_like(centers, float("inf"))
    n_final = torch.zeros((S,), dtype=torch.float32, device=dev)
    frozen = torch.zeros((S,), dtype=torch.bool, device=dev)
    halted = frozen.clone()
    n_iter = torch.zeros((S,), dtype=torch.int32, device=dev)
    it = 0
    while it < max_iter and not bool(halted.all()):
        counts, sums = ball_stats_fn(centers, points, bw2)
        means = sums / torch.clamp(counts, min=1.0)[:, None]
        empty = counts == 0
        # the kernel's shift: the sum of squares in index order, then the root
        diff = means - centers
        sq = diff[:, 0] * diff[:, 0]
        for k in range(1, diff.shape[1]):
            sq = sq + diff[:, k] * diff[:, k]
        newly_done = empty | (torch.sqrt(sq) < stop_thresh)
        new_centers = torch.where((halted | empty)[:, None], centers, means)
        # exact period-2 cycle: the trajectory repeats, so move the seed to
        # the phase it would hold after the remaining iterations and halt it
        cycle = (new_centers == prev).all(dim=1) & ~halted & ~newly_done
        final_pos = new_centers if (max_iter - (it + 1)) % 2 == 0 else centers
        new_centers = torch.where(cycle[:, None], final_pos, new_centers)
        n_final = torch.where(frozen, n_final, counts)
        n_iter = torch.where(halted, n_iter, it + 1)
        frozen = frozen | newly_done
        halted = halted | newly_done | cycle
        prev, centers = centers, new_centers
        it += 1
    # seeds that never froze record their population at their final position
    counts, _ = ball_stats_fn(centers, points, bw2)
    n_final = torch.where(frozen, n_final, counts)
    return centers, n_final, frozen, n_iter


def near_boundary(centers: torch.Tensor, points: PointSet, bw2: float) -> torch.Tensor:
    """Per center: does a valid point lie within rounding of its ball's
    boundary (float64 squared distance within ``1e-6 (|c|^2 + |x|^2) + 1e-5
    bw2`` of ``bw2``)? Two fits that sum ``c.x`` and the coordinates in other
    orders may decide such a point's ball test differently."""
    x = points.x.double()
    xn = (x * x).sum(1)
    out = torch.zeros(len(centers), dtype=torch.bool, device=centers.device)
    for i in range(0, len(centers), 64):
        c = centers[i:i + 64].double()
        cn = (c * c).sum(1)
        d2 = ((c[:, None, :] - x[None]) ** 2).sum(-1)
        tol = 1e-6 * (cn[:, None] + xn[None]) + 1e-5 * bw2
        out[i:i + 64] = (((d2 - bw2).abs() <= tol) & points.valid[None]).any(1)
    return out


def mean_shift_fit_plan(S: int, N: int, d: int):
    """The launch the kernel takes for ``(S, N, d)`` on the current card:
    ``(seeds per group, clusters, resident points per block, shared bytes)``."""
    lib = kernels.load("ball_stats", _SIGNATURES)
    out = (ctypes.c_int * 4)()
    kernels.check_launch(lib.mean_shift_fit_plan(S, N, d, ctypes.addressof(out)),
                         "mean_shift_fit_plan")
    return tuple(out)


def mean_shift_fit(
    seeds: torch.Tensor, points: PointSet, bw2: float, stop_thresh: float, max_iter: int
):
    """The whole fit: ``(centers (S, d), n_final (S,), frozen (S,) bool,
    n_iter (S,) int32)``, as :func:`mean_shift_fit_plain` defines them."""
    S, d = seeds.shape
    if not 1 <= d <= MAX_DIM or points.x.shape[1] != d:
        raise ValueError(
            f"seeds {tuple(seeds.shape)} and points {tuple(points.x.shape)} must share "
            f"d, 1 <= d <= {MAX_DIM}"
        )
    if seeds.device.type == "cpu":
        return mean_shift_fit_plain(seeds, points, bw2, stop_thresh, max_iter)
    if seeds.device.type != "cuda":
        raise ValueError(f"mean_shift_fit runs on CUDA or CPU tensors, not {seeds.device}")
    if points.x.device != seeds.device:
        raise ValueError(f"seeds on {seeds.device}, points on {points.x.device}")
    lib = kernels.load("ball_stats", _SIGNATURES)
    seeds = seeds.float().contiguous()
    dev = seeds.device
    centers = torch.empty((S, d), dtype=torch.float32, device=dev)
    n_final = torch.empty((S,), dtype=torch.float32, device=dev)
    frozen = torch.empty((S,), dtype=torch.bool, device=dev)
    n_iter = torch.empty((S,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mean_shift_fit_launch(
            seeds.data_ptr(), points.x.data_ptr(), points.x_norm.data_ptr(),
            points.valid.data_ptr(), float(bw2), float(stop_thresh), int(max_iter),
            S, points.x.shape[0], d, FIT_CLUSTER, centers.data_ptr(), n_final.data_ptr(),
            frozen.data_ptr(), n_iter.data_ptr(), stream,
        )
    kernels.check_launch(rc, "mean_shift_fit")
    kernels.count_launch(mean_shift_fit)
    return centers, n_final, frozen, n_iter


mean_shift_fit.launches = 0
