"""Grow-then-shrink halo removal as two disk-kernel convolutions.

Port of ``cellulus_tpu/ops/morphology.py``. The reference thresholds two
Euclidean distance transforms (``dtedt(seg == 0) < grow`` and
``dtedt(expanded) < shrink``); a thresholded EDT is binary morphology with
the disk ``{o : |o| < r}``, so each is one convolution of a 0/1 image with
a 0/1 disk (a ball in 3D, ``F.conv3d``) and a ``> 0.5`` test. Zero
padding reproduces scipy's within-array distance semantics; every sum is a
small integer (at most the ball's voxel count, 1331 for the 11^3 ball of
the default shrink distance), exact in float32 (and in TF32).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def disk_kernel(radius: float, ndim: int) -> np.ndarray:
    """Binary Euclidean ball: offsets with squared norm < radius^2."""
    r = max(0, int(np.ceil(radius)) - 1)
    axes = [np.arange(-r, r + 1)] * ndim
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=0)
    return ((grid**2).sum(axis=0) < radius**2).astype(np.float32)


_CONV = {2: F.conv2d, 3: F.conv3d}


def _touches(mask: torch.Tensor, radius: float) -> torch.Tensor:
    """Pixels within the open ball of ``radius`` of a set pixel of ``mask``
    (outside the array counts as unset)."""
    k = torch.from_numpy(disk_kernel(radius, mask.dim())).to(mask.device)
    r = (k.shape[0] - 1) // 2
    x = F.pad(mask.float()[None, None], (r, r) * mask.dim())
    return _CONV[mask.dim()](x, k[None, None])[0, 0] > 0.5


def halo_removal(
    segmentation: torch.Tensor, grow_distance: float, shrink_distance: float
) -> torch.Tensor:
    """Zero every pixel within ``shrink_distance`` of the background of the
    foreground grown by ``grow_distance``. ``segmentation`` is a 2D or 3D
    label image on the device."""
    if segmentation.dim() not in _CONV:
        raise ValueError(f"halo removal takes 2D or 3D label images, not {segmentation.dim()}D")
    expanded = _touches(segmentation > 0, grow_distance)
    near_background = _touches(~expanded, shrink_distance)
    return torch.where(near_background, torch.zeros_like(segmentation), segmentation)
