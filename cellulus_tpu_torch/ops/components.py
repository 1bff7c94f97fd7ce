"""Connected components, size filter and consecutive relabel.

Semantics of ``cellulus_tpu/ops/components.py`` (``size_filter`` after
``label``): full connectivity (8 in 2D, 26 in 3D), components of different
input ids stay separate, components below ``min_size`` pixels are dropped,
and the survivors are numbered from 1 in (input id, raster order of the
component's first pixel) order.

Two implementations with the same labels:

- :func:`cc_parents` + :func:`filter_relabel_device`, plain tensor ops on
  whatever device the labels lie on (the JAX package's device path,
  ``cellulus_tpu/ops/components.py:50-134,179-227``): every pixel's parent
  starts at its own flat index and falls to the component's minimum flat
  index, its first pixel in raster order, by rounds of segmented min-scans
  along each axis, a minimum over the diagonal neighbours and pointer
  jumping. :func:`size_filter_device` chains them.
- :func:`filter_relabel`, ``scipy.ndimage.label`` per id inside the id's
  bounding box, as the JAX package's oracle ``label_host`` does over the
  whole image; kept as the test oracle.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import numpy as np
import torch
from scipy import ndimage as ndi

# rounds of propagation between two convergence checks (each check is a
# device-to-host read)
CHECK_EVERY = 4


def _segmented_min(p: torch.Tensor, same_prev: torch.Tensor, axis: int) -> torch.Tensor:
    """Prefix minimum of ``p`` along ``axis`` within runs, a run restarting
    wherever ``same_prev`` is false. torch has no associative scan: a
    ``cummax`` over ``run_id * big + (big - 1 - p)`` is the segmented
    prefix minimum, since later runs have larger keys."""
    big = p.numel() + 1  # p lies in [0, N]
    run_id = torch.cumsum((~same_prev).to(torch.int64), dim=axis)
    key = torch.cummax(run_id * big + (big - 1 - p), dim=axis).values
    return big - 1 - (key - run_id * big)


def cc_parents(values: torch.Tensor, full_connectivity: bool = True,
               stats: Optional[dict] = None) -> torch.Tensor:
    """``values (*shape) -> parents (*shape)`` int64: background pixels map
    to the sentinel ``N = values.numel()`` and every other pixel to its
    component's minimum flat index, pixels of one component sharing a value.

    ``full_connectivity=False`` merges axis neighbours only (4 in 2D, 6 in
    3D: scipy's default ``binary_fill_holes`` structure). Each round runs,
    per axis, a segmented min-scan forward and then backward over runs of
    equal values (a straight run resolves in one round), the minimum over
    the diagonal neighbours, and one pointer-jumping step ``p <- p[p]``.
    Convergence is read every :data:`CHECK_EVERY` rounds; the fixpoint, and
    so the result, does not depend on when. ``stats``, when given, receives
    ``rounds``: the rounds run, checks included.
    """
    shape = tuple(values.shape)
    ndim = len(shape)
    N = math.prod(shape)
    device = values.device
    values = values.to(torch.int64)
    mask = values != 0
    v_pad = torch.nn.functional.pad(values, (1, 1) * ndim)
    idx = torch.arange(N, dtype=torch.int64, device=device).reshape(shape)
    parent = torch.where(mask, idx, torch.full_like(idx, N))

    def neighbour(pad, off):
        return pad[tuple(slice(o, o + s) for o, s in zip(off, shape))]

    def same_as(off):
        return (neighbour(v_pad, off) == values) & mask

    # runs along each axis: equal to the previous / the next pixel
    same_prev, same_next = [], []
    for axis in range(ndim):
        off = [1] * ndim
        off[axis] = 0
        same_prev.append(same_as(off))
        off[axis] = 2
        same_next.append(same_as(off).flip(axis))
    diagonal = []
    if full_connectivity:
        for off in itertools.product(range(3), repeat=ndim):
            if sum(o != 1 for o in off) >= 2:
                diagonal.append((off, same_as(off)))

    def one_round(p):
        for axis in range(ndim):
            p = _segmented_min(p, same_prev[axis], axis)
            p = _segmented_min(p.flip(axis), same_next[axis], axis).flip(axis)
        if diagonal:
            p_pad = torch.nn.functional.pad(p, (1, 1) * ndim, value=N)
            best = p
            for off, same in diagonal:
                best = torch.where(same, torch.minimum(best, neighbour(p_pad, off)), best)
            p = best
        flat = torch.cat([p.reshape(-1), p.new_full((1,), N)])
        return flat[p]

    rounds = 0
    while True:
        before = parent
        for _ in range(CHECK_EVERY):
            parent = one_round(parent)
        rounds += CHECK_EVERY
        if not bool((parent != before).any()):
            break
    if stats is not None:
        stats["rounds"] = rounds
    return parent


def filter_relabel_device(parents: torch.Tensor, values_at_parent: torch.Tensor,
                          min_size: int) -> torch.Tensor:
    """Drop components below ``min_size`` pixels and number the rest from 1
    in (input id, root index) order: ``(N,)`` uint16 labels from ``(N,)``
    root indices in ``[0, N]`` (``N`` = background) and the input id at each
    pixel's root (``cellulus_tpu/ops/components.py:filter_relabel_device``).

    Survivors are ranked by a stable sort on their id, so ties keep the
    root's index order; dropped roots sort last behind a sentinel above any
    id."""
    N = parents.shape[0]
    counts = torch.bincount(parents, minlength=N + 1)
    counts[N] = 0
    valid = (counts > 0) & (counts >= min_size)
    vals_root = torch.nn.functional.pad(values_at_parent.to(torch.int64), (0, 1))
    key = torch.where(valid, vals_root, torch.full_like(vals_root, torch.iinfo(torch.int32).max))
    order = torch.argsort(key, stable=True)
    valid_sorted = valid[order]
    ranks = torch.cumsum(valid_sorted.to(torch.int64), dim=0)
    rank_of_root = torch.zeros(N + 1, dtype=torch.int64, device=parents.device)
    rank_of_root[order] = torch.where(valid_sorted, ranks, torch.zeros_like(ranks))
    return rank_of_root[parents].to(torch.uint16)


def size_filter_device(values: torch.Tensor, min_size: int,
                       stats: Optional[dict] = None) -> torch.Tensor:
    """Components of ``values`` (full connectivity) below ``min_size``
    pixels dropped and the rest relabelled, on ``values``' device: uint16
    labels of the same shape. ``min_size == 0`` keeps the labels as they are
    (cast to uint16), without relabelling, as the reference does."""
    if min_size == 0:
        return values.to(torch.uint16)
    parents = cc_parents(values, stats=stats).reshape(-1)
    flat = torch.nn.functional.pad(values.reshape(-1).to(torch.int64), (0, 1))
    return filter_relabel_device(parents, flat[parents], int(min_size)).reshape(values.shape)


def filter_relabel(values: np.ndarray, min_size: int) -> np.ndarray:
    """Label the components of every non-zero id, drop those smaller than
    ``min_size`` pixels and number the rest consecutively (host oracle)."""
    values = np.ascontiguousarray(values, dtype=np.int64)
    structure = np.ones((3,) * values.ndim, dtype=bool)
    out = np.zeros(values.shape, dtype=np.int32)
    next_label = 0
    for index, bbox in enumerate(ndi.find_objects(values)):
        if bbox is None:
            continue
        comp, n = ndi.label(values[bbox] == index + 1, structure=structure)
        sizes = np.bincount(comp.ravel(), minlength=n + 1)[1:]
        keep = sizes >= min_size
        remap = np.zeros(n + 1, dtype=np.int32)
        remap[1:][keep] = np.arange(next_label + 1, next_label + 1 + keep.sum())
        region = out[bbox]
        hit = comp > 0
        region[hit] = remap[comp[hit]]
        next_label += int(keep.sum())
    return out
