"""Elastic augmentation on the device: the warp as torch tensor ops.

Port of ``cellulus_tpu/datasets/elastic_jax.py``. Same parameter model as
the host path (:mod:`.elastic`, gunpowder's ElasticAugment as the reference
uses it, ``datasets/zarr_dataset.py:123-132``): a rotation in [0, pi/2)
acting in the trailing (y, x) plane, a scale in [0.9, 1.1), a smooth
displacement field from jittered control points (upsampled twice,
subsample factor 4), reverse mapping with linear interpolation and reflect
boundaries.

Run in front of a key-driven train step, the warp leaves the data workers
only the padded read, so ``transfer_precision="native"`` (crops in the
source dtype, normalised by the step) combines with augmentation. The
draws come from a ``torch.Generator``, so results match the host path in
distribution, not bit for bit; given the same parameters the grid and the
interpolation equal the JAX package's.

Two pieces are written out rather than taken from the library, because the
library's differ at the edges:

- :func:`resize_linear` is ``jax.image.resize(..., "linear")``: half-pixel
  aligned sample positions, a triangle kernel (widened when downsampling,
  as JAX antialiases), weights normalised per output sample and zero where
  the sample lies wholly outside the input. ``F.interpolate`` clamps the
  source index instead of renormalising, and never widens the kernel.
- :func:`map_coordinates_linear` gathers with scipy's ``mode="reflect"``
  index folding (``d c b a | a b c d | d c b a``), which neither
  ``align_corners`` setting of ``F.grid_sample(padding_mode="reflection")``
  reproduces.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .elastic import ROTATION_INTERVAL, SCALE_INTERVAL, SUBSAMPLE


def _resize_weights(input_size: int, output_size: int, device) -> torch.Tensor:
    """``(input_size, output_size)`` float32 weights of JAX's linear
    ``compute_weight_mat`` (scale = output / input, no translation), built
    on ``device``: no copy from the host, so the warp captures in a CUDA
    graph (the two scales are host scalars, kernel arguments)."""
    f32 = torch.float32
    inv_scale = torch.tensor(1.0 / (output_size / input_size), dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(output_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(input_size, dtype=f32, device=device)[:, None]).abs()
    x = x / kernel_scale
    weights = torch.clamp(1 - x, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * torch.finfo(f32).eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample >= -0.5) & (sample <= input_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_linear(x: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """``jax.image.resize(x, (*lead, *shape), "linear")`` over the trailing
    ``len(shape)`` axes of float32 ``x``: one weight matrix contracted per
    axis whose size changes."""
    ndim = len(shape)
    for i, n in enumerate(shape):
        axis = x.dim() - ndim + i
        m = x.shape[axis]
        if m == n:
            continue
        w = _resize_weights(m, n, x.device)
        x = torch.movedim(torch.movedim(x, axis, -1) @ w, -1, axis)
    return x


def deformation_grid(
    crop_size: Tuple[int, ...],
    padded_spatial: Tuple[int, ...],
    rotation: torch.Tensor,
    scale: torch.Tensor,
    control_points: Optional[torch.Tensor],
) -> torch.Tensor:
    """Reverse-mapping sample grid ``(..., D, *crop)`` in padded-source
    coordinates, step for step the host grid of
    :func:`.elastic.elastic_deform`.

    ``rotation`` and ``scale`` are float32 tensors of one batch shape ``...``
    (``()`` for one crop); ``control_points`` is ``(..., D, *n_cp)`` or None.
    """
    ndim = len(crop_size)
    device = rotation.device
    axes = [torch.arange(s, dtype=torch.float32, device=device) - (s - 1) / 2.0
            for s in crop_size]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0)
    grid = grid.expand(*rotation.shape, *grid.shape)
    per_axis = list(grid.unbind(dim=-ndim - 1))
    spread = (...,) + (None,) * ndim
    cos, sin = torch.cos(rotation)[spread], torch.sin(rotation)[spread]
    gy, gx = per_axis[-2], per_axis[-1]
    per_axis[-2] = cos * gy - sin * gx
    per_axis[-1] = sin * gy + cos * gx
    grid = torch.stack(per_axis, dim=-ndim - 1) / scale[(...,) + (None,) * (ndim + 1)]

    if control_points is not None:
        sub_shape = tuple(max(2, s // SUBSAMPLE) for s in crop_size)
        disp = resize_linear(resize_linear(control_points, sub_shape), tuple(crop_size))
        grid = grid + disp

    # each axis's centre added as a scalar: no copy from the host
    centers = [(p - 1) / 2.0 for p in padded_spatial]
    return torch.stack([g + c for g, c in zip(grid.unbind(dim=-ndim - 1), centers)],
                       dim=-ndim - 1)


def _reflect_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """scipy mode="reflect" (d c b a | a b c d | d c b a) index folding."""
    period = 2 * size
    idx = torch.remainder(idx, period)
    return torch.where(idx >= size, period - 1 - idx, idx)


def map_coordinates_linear(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Linear sampling with reflect boundaries, channels last.

    Args:
        image: ``(B, *padded_spatial, C)``, any real dtype.
        grid: ``(B, D, *crop)`` float32 sample coordinates.

    Returns:
        ``(B, *crop, C)`` float32: the ``2^D`` corners summed in the JAX
        package's order, each weight the product of its per-axis factors.
    """
    batch, ndim = grid.shape[:2]
    crop, padded = grid.shape[2:], image.shape[1:-1]
    channels = image.shape[-1]
    lo = torch.floor(grid).to(torch.int64)
    frac = grid - lo
    # widened first: the source dtypes (uint8, uint16) gather exactly as float32
    rows = image.reshape(-1, channels).float()
    base = (torch.arange(batch, device=grid.device) * math.prod(padded)).reshape(
        (batch,) + (1,) * len(crop))
    out = torch.zeros((batch, *crop, channels), dtype=torch.float32, device=grid.device)
    for corner in range(1 << ndim):
        flat = torch.zeros_like(lo[:, 0])
        weight = torch.ones(grid.shape[:1] + grid.shape[2:], dtype=torch.float32,
                            device=grid.device)
        for d in range(ndim):
            bit = (corner >> d) & 1
            flat = flat * (padded[d] if d else 1) + _reflect_index(lo[:, d] + bit, padded[d])
            weight = weight * (frac[:, d] if bit else 1.0 - frac[:, d])
        values = rows[(flat + base).reshape(-1)].reshape(batch, *crop, channels)
        out = out + weight[..., None] * values
    return out


def draw_deformations(
    generator: torch.Generator,
    batch: int,
    crop_size: Tuple[int, ...],
    control_point_spacing: int,
    control_point_jitter: float,
    device,
):
    """``(rotation (B,), scale (B,), control_points (B, D, *n_cp) or None)``,
    one deformation per batch element, drawn from ``generator`` in that
    order."""
    rotation = torch.empty(batch, device=device).uniform_(*ROTATION_INTERVAL, generator=generator)
    scale = torch.empty(batch, device=device).uniform_(*SCALE_INTERVAL, generator=generator)
    control_points = None
    if control_point_jitter > 0:
        n_cp = tuple(max(2, int(math.ceil(s / control_point_spacing)) + 1) for s in crop_size)
        control_points = torch.randn((batch, len(crop_size), *n_cp), generator=generator,
                                     device=device) * control_point_jitter
    return rotation, scale, control_points


def elastic_deform_device(
    padded: torch.Tensor,
    crop_size: Tuple[int, ...],
    control_point_spacing: int,
    control_point_jitter: float,
    generator: torch.Generator,
) -> torch.Tensor:
    """Deform one padded crop ``(C, *padded_spatial)`` (any dtype, source
    units) into ``(C, *crop_size)`` float32."""
    x = torch.movedim(padded, 0, -1)[None]
    out = elastic_deform_batch(crop_size, control_point_spacing, control_point_jitter)(
        x, generator)
    return torch.movedim(out[0], -1, 0)


def elastic_deform_batch(
    crop_size: Tuple[int, ...],
    control_point_spacing: int,
    control_point_jitter: float,
    batch_size: Optional[int] = None,
    rows: Optional[slice] = None,
):
    """Batched channels-last deform: ``fn(raw (B, *padded, C), generator) ->
    (B, *crop, C)`` float32, an independent deformation per batch element.

    With ``batch_size`` and ``rows`` (a data-parallel rank) the deformations
    are drawn for the global batch of ``batch_size`` and ``raw`` holds its
    ``rows``, which take theirs."""
    crop_size = tuple(int(c) for c in crop_size)

    def fn(raw: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        rotation, scale, control_points = draw_deformations(
            generator, batch_size or raw.shape[0], crop_size, control_point_spacing,
            control_point_jitter, raw.device)
        if rows is not None:
            rotation, scale = rotation[rows], scale[rows]
            control_points = None if control_points is None else control_points[rows]
        grid = deformation_grid(crop_size, tuple(raw.shape[1:-1]), rotation, scale,
                                control_points)
        return map_coordinates_linear(raw, grid)

    return fn
