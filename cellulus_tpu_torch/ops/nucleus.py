"""Nucleus partition of all instances of a sample at once, on the device.

Port of ``cellulus_tpu/ops/nucleus.py`` (``_nucleus_body``, the JAX
package's device path of the "nucleus" post-processing mode), in plain
tensor ops on whatever device the labels lie on:

1. per-id minimum and maximum of the raw image (scatter reductions);
2. a 256-bin histogram per id over the id's own ``[min, max]`` (bins by
   truncation of ``(raw - min) / span * 256``, float32 in the JAX op order,
   so a pixel on a bin edge lands in the same bin);
3. Otsu batched over the ids (the formula of ``ops/otsu.py``);
4. ``keep = raw > thr[id]``, constant-intensity ids kept whole;
5. hole filling: the axis-connected components of the dropped set
   (:func:`~.components.cc_parents` with ``full_connectivity=False``),
   where a component that touches no border and whose axis neighbours
   carry exactly one id takes that id.

As the JAX device path, it differs from the per-instance host loop
(``segment.nucleus_partition``) at NESTED instances: a cavity of instance A
that holds another instance B is left unfilled here (its neighbours are
{A, B}), while the host loop fills it with A over B's pixels
(``cellulus_tpu/ops/nucleus.py:22-28``). And its Otsu sums in float32
(on the card in another order than on the CPU), the host's in float64:
where two bins' variances nearly tie, an id's threshold can land on
another bin.
"""

from __future__ import annotations

import numpy as np
import torch

from .components import cc_parents

NBINS = 256


def _scatter(size: int, index: torch.Tensor, src: torch.Tensor, reduce: str,
             fill) -> torch.Tensor:
    out = torch.full((size,), fill, dtype=src.dtype, device=src.device)
    return out.scatter_reduce(0, index, src, reduce)


def otsu_per_id(flat_seg: torch.Tensor, flat_raw: torch.Tensor, num_ids: int):
    """Steps 1-3 for every id at once: ``(thr (num_ids,), const (num_ids,))``,
    the Otsu threshold of each id's raw values and whether they are all one
    value. ``flat_seg`` int64 ids (0 = background), ``flat_raw`` float32."""
    fg = flat_seg > 0

    # 1. per-id intensity range (id 0 absorbs the background rows)
    sidx = torch.where(fg, flat_seg, torch.zeros_like(flat_seg))
    big = float(np.finfo(np.float32).max)
    mins = _scatter(num_ids, sidx, torch.where(fg, flat_raw, big), "amin", big)
    maxs = _scatter(num_ids, sidx, torch.where(fg, flat_raw, -big), "amax", -big)
    span = maxs - mins
    const = span <= 0  # single-valued instance: keep the whole mask

    # 2. per-id histogram over each id's own [min, max]
    denom = torch.where(const, torch.ones_like(span), span)
    b = torch.clamp(((flat_raw - mins[sidx]) / denom[sidx] * NBINS).to(torch.int32), 0, NBINS - 1)
    hist = torch.zeros((num_ids, NBINS), dtype=torch.float32, device=flat_seg.device)
    hist.index_put_((sidx, torch.where(fg, b, torch.zeros_like(b)).to(torch.int64)),
                    fg.to(torch.float32), accumulate=True)

    # 3. Otsu per id (rows = ids)
    steps = torch.arange(NBINS + 1, dtype=torch.float32, device=flat_seg.device)
    edges = mins[:, None] + span[:, None] * steps / NBINS
    centers = (edges[:, :-1] + edges[:, 1:]) / 2
    w1 = torch.cumsum(hist, dim=1)
    w2 = torch.cumsum(hist.flip(1), dim=1).flip(1)
    m1 = torch.cumsum(hist * centers, dim=1) / torch.clamp(w1, min=1e-12)
    m2 = (torch.cumsum((hist * centers).flip(1), dim=1)
          / torch.clamp(w2.flip(1), min=1e-12)).flip(1)
    variance12 = w1[:, :-1] * w2[:, 1:] * (m1[:, :-1] - m2[:, 1:]) ** 2
    thr = torch.gather(centers, 1, torch.argmax(variance12, dim=1, keepdim=True))[:, 0]
    return thr, const


def nucleus_partition_device(seg: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """``(seg (*shape) integer ids, raw (*shape)) -> labels (*shape)`` int64
    on ``seg``'s device (``cellulus_tpu/ops/nucleus.py:_nucleus_body``)."""
    shape = tuple(seg.shape)
    ndim = len(shape)
    N = seg.numel()
    flat_seg = seg.reshape(-1).to(torch.int64)
    flat_raw = raw.reshape(-1).to(torch.float32)
    num_ids = int(flat_seg.max()) + 1 if N else 1
    fg = flat_seg > 0
    sidx = torch.where(fg, flat_seg, torch.zeros_like(flat_seg))
    thr, const = otsu_per_id(flat_seg, flat_raw, num_ids)

    # 4. keep what lies above the id's threshold
    keep = fg & (const[sidx] | (flat_raw > thr[sidx]))
    kept = torch.where(keep, flat_seg, torch.zeros_like(flat_seg)).reshape(shape)

    # 5. hole fill: axis-connected components of the dropped set; interior
    # components with exactly one distinct neighbouring id take that id
    parents = cc_parents((kept == 0).to(torch.int64), full_connectivity=False)
    pflat = parents.reshape(-1)  # in [0, N]; N = sentinel for kept pixels
    border = torch.zeros(shape, dtype=torch.bool, device=seg.device)
    for axis in range(ndim):
        border.narrow(axis, 0, 1).fill_(True)
        border.narrow(axis, shape[axis] - 1, 1).fill_(True)
    outside = _scatter(N + 1, pflat, border.reshape(-1).to(torch.int64), "amax", 0) > 0

    int_max = torch.iinfo(torch.int64).max
    k_pad = torch.nn.functional.pad(kept, (1, 1) * ndim)
    nbr_min = torch.full(shape, int_max, dtype=torch.int64, device=seg.device)
    nbr_max = torch.zeros(shape, dtype=torch.int64, device=seg.device)
    for axis in range(ndim):
        for start in (0, 2):
            off = [1] * ndim
            off[axis] = start
            nbr = k_pad[tuple(slice(o, o + s) for o, s in zip(off, shape))]
            nbr_min = torch.where(nbr > 0, torch.minimum(nbr_min, nbr), nbr_min)
            nbr_max = torch.maximum(nbr_max, nbr)
    comp_min = _scatter(N + 1, pflat, nbr_min.reshape(-1), "amin", int_max)
    comp_max = _scatter(N + 1, pflat, nbr_max.reshape(-1), "amax", 0)
    fill = torch.where(~outside & (comp_max > 0) & (comp_min == comp_max), comp_max,
                       torch.zeros_like(comp_max))
    return torch.where(kept == 0, fill[pflat].reshape(shape), kept)
