"""Mean-shift ball statistics.

For ``S`` seeds and ``N`` points in ``d <= 8`` dimensions::

    counts[s] = #{ valid x : |x - c_s|^2 <= bw^2 }     (inclusive)
    sums[s]   = sum of those x

with ``|x - c|^2`` computed as ``(|c|^2 + |x|^2) - 2 c.x``.

Replaces the TPU kernel
``cellulus_tpu/ops/pallas_mean_shift.py:ball_stats_padded``. On CUDA tensors
:func:`ball_stats` launches ``csrc/ball_stats.cu`` (design and bound in its
header); on CPU tensors it runs :func:`ball_stats_plain`, the chunked
matmul form of ``cellulus_tpu/ops/mean_shift.py:_make_ball_stats``. The
mean-shift fit does not call it: it runs whole in one launch
(:mod:`~cellulus_tpu_torch.ops.mean_shift_fit`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import kernels

MAX_DIM = 8

# every C entry point of csrc/ball_stats.cu (the library is loaded once)
_SIGNATURES = {
    "ball_stats_launch": (
        [ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 3,
        ctypes.c_int,
    ),
    "mean_shift_fit_launch": (
        [ctypes.c_void_p] * 5 + [ctypes.c_float] * 2 + [ctypes.c_int] * 6
        + [ctypes.c_void_p] * 5,
        ctypes.c_int,
    ),
    "mean_shift_fit_plan": ([ctypes.c_int] * 2 + [ctypes.c_void_p], ctypes.c_int),
}


class PointSet(NamedTuple):
    """Points prepared once for many ball-statistics calls."""

    x: torch.Tensor  # (N, d) float32, contiguous
    x_norm: torch.Tensor  # (N,) float32: sum of squares per point
    valid: torch.Tensor  # (N,) bool


def point_set(x: torch.Tensor, valid: torch.Tensor) -> PointSet:
    x = x.float().contiguous()
    if x.dim() != 2 or not 1 <= x.shape[1] <= MAX_DIM:
        raise ValueError(f"points must be (N, d) with 1 <= d <= {MAX_DIM}, got {tuple(x.shape)}")
    valid = valid.to(device=x.device, dtype=torch.bool).contiguous()
    if valid.shape != (x.shape[0],):
        raise ValueError(f"valid must be ({x.shape[0]},), got {tuple(valid.shape)}")
    return PointSet(x, (x * x).sum(dim=1), valid)


def _plain_chunk(S: int) -> int:
    # bound the (S, chunk) distance matrix to 2^24 floats
    return max(256, (1 << 24) // max(S, 1))


def ball_stats_plain(centers: torch.Tensor, points: PointSet, bw2: float):
    """Plain PyTorch version: ``(counts (S,), sums (S, d))`` in float32."""
    centers = centers.float()
    S, d = centers.shape
    c_norm = (centers * centers).sum(dim=1)
    counts = torch.zeros((S,), dtype=torch.float32, device=centers.device)
    sums = torch.zeros((S, d), dtype=torch.float32, device=centers.device)
    chunk = _plain_chunk(S)
    for start in range(0, points.x.shape[0], chunk):
        sl = points.x[start : start + chunk]
        cross = centers @ sl.T
        d2 = c_norm[:, None] + points.x_norm[None, start : start + chunk] - 2.0 * cross
        w = ((d2 <= bw2) & points.valid[None, start : start + chunk]).float()
        counts += w.sum(dim=1)
        sums += w @ sl
    return counts, sums


def ball_stats(centers: torch.Tensor, points: PointSet, bw2: float):
    """Population and coordinate sum of the valid points within
    ``sqrt(bw2)`` of each center: ``(counts (S,), sums (S, d))``."""
    if centers.device.type == "cpu":
        return ball_stats_plain(centers, points, bw2)
    if centers.device.type != "cuda":
        raise ValueError(f"ball_stats runs on CUDA or CPU tensors, not {centers.device}")
    S, d = centers.shape
    if d != points.x.shape[1] or points.x.device != centers.device:
        raise ValueError(
            f"centers {tuple(centers.shape)} on {centers.device} do not match "
            f"points {tuple(points.x.shape)} on {points.x.device}"
        )
    lib = kernels.load("ball_stats", _SIGNATURES)
    centers = centers.float().contiguous()
    c_norm = (centers * centers).sum(dim=1)
    counts = torch.empty((S,), dtype=torch.float32, device=centers.device)
    sums = torch.empty((S, d), dtype=torch.float32, device=centers.device)
    with torch.cuda.device(centers.device):
        stream = torch.cuda.current_stream(centers.device).cuda_stream
        rc = lib.ball_stats_launch(
            centers.data_ptr(), c_norm.data_ptr(), points.x.data_ptr(),
            points.x_norm.data_ptr(), points.valid.data_ptr(), float(bw2),
            S, points.x.shape[0], d, counts.data_ptr(), sums.data_ptr(), stream,
        )
    kernels.check_launch(rc, "ball_stats")
    kernels.count_launch(ball_stats)
    return counts, sums


ball_stats.launches = 0
