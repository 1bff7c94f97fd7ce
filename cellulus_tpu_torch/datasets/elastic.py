"""Elastic augmentation for training crops.

A copy of ``cellulus_tpu/datasets/elastic.py`` (numpy and scipy only).

Re-implements the behavior of gunpowder's ``ElasticAugment`` node as used by
the reference (``datasets/zarr_dataset.py:123-132``): a smooth random
deformation built from jittered control points (spacing
``control_point_spacing``, jitter stddev ``control_point_jitter``), a random
rotation in ``[0, pi/2]`` and a random scale in ``[0.9, 1.1]``, with the
displacement field computed on a subsampled grid (factor 4) and upsampled.

Rather than deforming an already-extracted crop (which would pull undefined
content in at the borders), the sampler reads a padded source region and this
module pulls the output crop out of it with reverse mapping + linear
interpolation, mirroring gunpowder's upstream-ROI growth.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy.ndimage import map_coordinates, zoom

ROTATION_INTERVAL = (0.0, math.pi / 2)
SCALE_INTERVAL = (0.9, 1.1)
SUBSAMPLE = 4


def required_margin(crop_size: Tuple[int, ...], control_point_jitter: float) -> int:
    """Margin (per side, per dim) the source read needs so that any rotation/
    scale/jitter stays inside the padded region.

    Rotation and scale COMPOSE multiplicatively (the sampling grid is
    rotated, then divided by scale), so a square crop's corner lands at
    radius ``(side-1)/2 * sqrt(2) / scale_min`` in source coordinates —
    adding the two margins linearly (as before) under-read for crop sides
    beyond ~250 px, letting map_coordinates' reflect mode silently fill
    corners with mirrored content."""
    side = max(crop_size)
    rot_scale = (
        int(math.ceil((side - 1) / 2 * (math.sqrt(2) / SCALE_INTERVAL[0] - 1)))
        + 1
    )
    jitter = int(math.ceil(4 * control_point_jitter)) + 1
    return rot_scale + jitter


def elastic_deform(
    padded: np.ndarray,
    crop_size: Tuple[int, ...],
    control_point_spacing: int,
    control_point_jitter: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Deform a padded source region into an output crop.

    Args:
        padded: ``(C, *padded_spatial)`` source with ``padded_spatial =
            crop_size + 2 * margin``.
        crop_size: target spatial size.

    Returns:
        ``(C, *crop_size)`` deformed crop.
    """
    ndim = len(crop_size)
    rotation = rng.uniform(*ROTATION_INTERVAL)
    scale = rng.uniform(*SCALE_INTERVAL)

    # output pixel grid, centered
    axes = [np.arange(s, dtype=np.float32) - (s - 1) / 2 for s in crop_size]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=0)  # (D, *crop)

    # rotation acts in the trailing (y, x) plane; z (if present) is untouched
    cos, sin = math.cos(rotation), math.sin(rotation)
    gy, gx = grid[-2], grid[-1]
    ry = cos * gy - sin * gx
    rx = sin * gy + cos * gx
    grid[-2], grid[-1] = ry, rx
    grid = grid / scale

    # smooth random displacement field from jittered control points,
    # computed at 1/SUBSAMPLE resolution then upsampled
    if control_point_jitter > 0:
        sub_shape = tuple(max(2, s // SUBSAMPLE) for s in crop_size)
        n_cp = tuple(
            max(2, int(np.ceil(s / control_point_spacing)) + 1) for s in crop_size
        )
        disp_sub = np.empty((ndim, *sub_shape), dtype=np.float32)
        for d in range(ndim):
            cp = rng.normal(0.0, control_point_jitter, size=n_cp).astype(np.float32)
            disp_sub[d] = zoom(
                cp,
                [s / c for s, c in zip(sub_shape, n_cp)],
                order=1,
                mode="nearest",
                grid_mode=True,
            )
        for d in range(ndim):
            grid[d] = grid[d] + zoom(
                disp_sub[d],
                [s / ss for s, ss in zip(crop_size, sub_shape)],
                order=1,
                mode="nearest",
                grid_mode=True,
            )

    # shift into padded-source coordinates
    for d in range(ndim):
        center = (padded.shape[1 + d] - 1) / 2
        grid[d] = grid[d] + center

    out = np.empty((padded.shape[0], *crop_size), dtype=np.float32)
    for c in range(padded.shape[0]):
        out[c] = map_coordinates(
            padded[c], grid, order=1, mode="reflect", output=np.float32
        )
    return out
