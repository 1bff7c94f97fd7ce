"""Anchor/reference pixel-pair sampling.

A copy of ``cellulus_tpu/datasets/sampling.py`` (host sampler, numpy), plus
the device sampler as a torch function. Reference parity
(``datasets/zarr_dataset.py:177-248``):

- anchors are uniform integer coordinates in ``[kappa, output - kappa]``
  (inclusive) per spatial dim, ``num_anchors = density * unbiased[0] *
  unbiased[1]`` (only the first two dims, even in 3D — reference
  ``zarr_dataset.py:244-245``),
- each anchor is repeated ``num_references = density * kappa^2 * pi`` times,
- reference pixels are ``anchor + offset`` with the offset drawn uniformly
  from the non-zero integer lattice points strictly inside the kappa-disk.

The reference draws offsets by rejection sampling; here the valid offset
lattice is precomputed once (it is a static set), and sampling is a single
uniform index draw — equivalent in distribution.

Coordinates are x-first: component 0 is x (fastest-varying axis), matching
the reference's gather convention (``models/unet.py:108-124``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def disk_offsets(radius: float, num_spatial_dims: int) -> np.ndarray:
    """All non-zero integer offsets with squared norm < radius^2, ``(M, D)``."""
    r = int(math.ceil(radius))
    axes = [np.arange(-r, r + 1)] * num_spatial_dims
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(
        -1, num_spatial_dims
    )
    sq = (grid**2).sum(axis=1)
    keep = (sq < radius**2) & (sq > 0)
    return grid[keep].astype(np.int32)


def num_anchors(
    density: float, unbiased_shape: Tuple[int, ...], count_mode: str = "reference"
) -> int:
    """Anchors per crop. ``"reference"`` replicates the reference's formula,
    which uses only the first two dims even in 3D (reference
    ``zarr_dataset.py:244-245``); ``"all_dims"`` scales with the full
    unbiased volume."""
    if count_mode == "all_dims":
        return int(density * math.prod(unbiased_shape))
    return int(density * unbiased_shape[0] * unbiased_shape[1])


def _ball_volume(radius: float, ndim: int) -> float:
    return math.pi ** (ndim / 2) / math.gamma(ndim / 2 + 1) * radius**ndim


def num_references(
    density: float, kappa: float, num_spatial_dims: int = 2,
    count_mode: str = "reference",
) -> int:
    """References per anchor: ``density * |kappa-disk|`` in the reference
    (2D area even in 3D, reference ``zarr_dataset.py:247-248``);
    ``"all_dims"`` uses the kappa-ball volume of the actual dimensionality."""
    if count_mode == "all_dims":
        return int(density * _ball_volume(kappa, num_spatial_dims))
    return int(density * kappa**2 * math.pi)


@dataclass
class PairSampler:
    """Samples (anchor, reference) coordinate pairs for one crop.

    All shapes are static per configuration: ``sample()`` returns arrays of
    shape ``(num_pairs, D)`` with ``num_pairs = num_anchors * num_references``.
    """

    output_shape: Tuple[int, ...]
    density: float
    kappa: float
    count_mode: str = "reference"

    def __post_init__(self):
        self.num_spatial_dims = len(self.output_shape)
        self.unbiased_shape = tuple(
            int(s - 2 * self.kappa) for s in self.output_shape
        )
        if any(s <= 0 for s in self.unbiased_shape):
            raise ValueError(
                f"output shape {self.output_shape} too small for kappa="
                f"{self.kappa}"
            )
        self.n_anchors = num_anchors(
            self.density, self.unbiased_shape, self.count_mode
        )
        self.n_references = num_references(
            self.density, self.kappa, self.num_spatial_dims, self.count_mode
        )
        if self.n_anchors < 1 or self.n_references < 1:
            raise ValueError(
                "density/kappa too small: no pairs would be sampled "
                f"(anchors={self.n_anchors}, references={self.n_references})"
            )
        self._offsets = disk_offsets(self.kappa, self.num_spatial_dims)

    @property
    def num_pairs(self) -> int:
        return self.n_anchors * self.n_references

    def _bounds(self):
        """``(lows, highs)`` per x-first component, ``highs`` exclusive:
        component ``d`` indexes spatial axis ``D-1-d`` of the prediction."""
        k = int(self.kappa)
        highs = [int(s) - k + 1 for s in reversed(self.output_shape)]
        return [k] * self.num_spatial_dims, highs

    def sample(self, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """Draw ``(anchors, references)`` of shape ``(num_pairs, D)`` (int32),
        x-first (for the reference's square crops the bound of component
        ``d`` equals the reference's ``output_shape[d]`` bound,
        ``zarr_dataset.py:202-235``)."""
        lows, highs = self._bounds()
        anchors = np.stack(
            [
                rng.integers(lo, hi, size=self.n_anchors)
                for lo, hi in zip(lows, highs)
            ],
            axis=1,
        ).astype(np.int32)
        anchors = np.repeat(anchors, self.n_references, axis=0)
        idx = rng.integers(0, len(self._offsets), size=len(anchors))
        references = anchors + self._offsets[idx]
        return anchors, references

    def device_sampler_grouped(self, device):
        """Return ``sample(generator, batch) -> (anchors (B, A, D), references
        (B, A, R, D))``, int64 on ``device``, drawn with ``generator`` (a
        ``torch.Generator`` on ``device``).

        Same distribution as :meth:`sample`, each anchor listed once with its
        R references, so the train step gathers each anchor embedding once
        and broadcasts it over its references.
        """
        device = torch.device(device)
        offsets = torch.from_numpy(self._offsets).long().to(device)
        lows, highs = self._bounds()
        n_anchors, n_refs = self.n_anchors, self.n_references

        def sample(generator: torch.Generator, batch: int):
            anchors = torch.stack(
                [
                    torch.randint(lo, hi, (batch, n_anchors), generator=generator,
                                  device=device)
                    for lo, hi in zip(lows, highs)
                ],
                dim=-1,
            )
            idx = torch.randint(0, offsets.shape[0], (batch, n_anchors, n_refs),
                                generator=generator, device=device)
            references = anchors[:, :, None, :] + offsets[idx]
            return anchors, references

        return sample
