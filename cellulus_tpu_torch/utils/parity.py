"""Comparing two detections of the same input up to rounding.

Two mean-shift fits that sum in other orders (the kernel and the plain
version, or the port and the JAX package) may part ways where a seed's
trajectory meets a point within rounding of a ball's boundary
(:func:`~cellulus_tpu_torch.ops.mean_shift_fit.near_boundary`); two
predicts may label differently a pixel within rounding of equidistance
from two kept centres, or of the bandwidth from its nearest one. Greedy
clustering's proposals may differ at a pixel whose affinity to the seed
lies within rounding of 0.5. These helpers find where two partitions
disagree and whether each such pixel is one of those cases. The checks
use them; the port's stages do not.
"""

from __future__ import annotations

import numpy as np

from ..detect import mean_center_embeddings, sample_rng
from ..ops import mean_shift as ms
from ..ops.otsu import threshold_otsu
from ..ops.peaks import smooth_peak_seeds

# a kept centre farther than this from every kept centre of the other side
# has parted ways
PARTED = 1e-3


def disagreeing(a, b):
    """``(mask of the pixels whose pair of labels is not a mutual majority
    match, {label of b: its majority partner in a}, {label of a: its
    majority partner in b})``."""
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    pairs, counts = np.unique(np.stack([a, b]), axis=1, return_counts=True)
    best_ab, best_ba = {}, {}
    for (x, y), n in zip(pairs.T.tolist(), counts.tolist()):
        if n > best_ab.get(x, (None, 0))[1]:
            best_ab[x] = (y, n)
        if n > best_ba.get(y, (None, 0))[1]:
            best_ba[y] = (x, n)
    bad = np.array([best_ab[x][0] != y or best_ba[y][0] != x
                    for x, y in zip(a.tolist(), b.tolist())], dtype=bool)
    return (bad, {y: x for y, (x, _) in best_ba.items()},
            {x: y for x, (y, _) in best_ab.items()})


def parted(kept, other):
    """Per kept centre: no centre of ``other`` lies within PARTED."""
    kept, other = np.asarray(kept, np.float64), np.asarray(other, np.float64)
    if len(other) == 0:
        return np.ones(len(kept), bool)
    return np.sqrt(((kept[:, None] - other[None]) ** 2).sum(-1)).min(1) > PARTED


def unexplained_mean_shift(mine, theirs, mask, X, kept_mine, kept_theirs, bw2):
    """Pixels where two mean-shift detections (labels: 1 + the kept
    centre's index, 0 for background and orphans) disagree and that neither
    a parted kept centre nor predict rounding explains. ``X``: ``(n, d)``
    points of the ``mask`` pixels in raster order. Returns ``(unexplained
    raster indices, parted centres of mine, of theirs)``."""
    bad, partner, _ = disagreeing(mine, theirs)
    p_mine, p_theirs = parted(kept_mine, kept_theirs), parted(kept_theirs, kept_mine)
    a, b = np.asarray(mine).ravel(), np.asarray(theirs).ravel()
    row = np.full(a.shape, -1)
    row[np.flatnonzero(np.asarray(mask).ravel())] = np.arange(len(X))
    c = np.asarray(kept_mine, np.float64)
    out = []
    for p in np.flatnonzero(bad):
        lp, lj = int(a[p]), int(b[p])
        if (lp and p_mine[lp - 1]) or (lj and p_theirs[lj - 1]):
            continue
        if row[p] >= 0 and len(c):
            x = np.asarray(X[row[p]], np.float64)
            d2 = ((c - x) ** 2).sum(1)
            tol = 1e-6 * ((x * x).sum() + (c * c).sum(1)) + 1e-5 * bw2
            other = partner.get(lj, 0)
            if lp and other:  # equidistant from two kept centres, within rounding
                if abs(d2[lp - 1] - d2[other - 1]) <= max(tol[lp - 1], tol[other - 1]):
                    continue
            else:  # an orphan on one side: its nearest centre at the bandwidth
                i = int(np.argmin(d2))
                if abs(d2[i] - bw2) <= tol[i]:
                    continue
        out.append(int(p))
    return out, int(p_mine.sum()), int(p_theirs.sum())


def unexplained_greedy(mine, theirs, emb, seeds_mine, seeds_theirs, bandwidth):
    """Pixels where two greedy clusterings (instance ids from 1, 0 for
    none) disagree and whose affinity to the seed of neither instance lies
    within rounding of 0.5 (``|exp(-d^2 / (2 bw^2)) - 0.5| <= 1e-6``, d^2
    in float64). ``emb``: ``(P, d)`` absolute embeddings in raster order;
    ``seeds_*[i]``: the pixel that seeded instance ``i + 1``."""
    bad, partner_ba, partner_ab = disagreeing(mine, theirs)
    a, b = np.asarray(mine).ravel(), np.asarray(theirs).ravel()
    emb = np.asarray(emb, np.float64)
    out = []
    for p in np.flatnonzero(bad):
        la, lb = int(a[p]), int(b[p])
        seeds = [seeds_mine[la - 1] if la else None, seeds_theirs[lb - 1] if lb else None,
                 seeds_theirs[partner_ab[la] - 1] if partner_ab.get(la) else None,
                 seeds_mine[partner_ba[lb] - 1] if partner_ba.get(lb) else None]
        d2 = [((emb[p] - emb[s]) ** 2).sum() for s in seeds if s is not None]
        if not any(abs(np.exp(-v / (2.0 * bandwidth**2)) - 0.5) <= 1e-6 for v in d2):
            out.append(int(p))
    return out


def mean_shift_fit_inputs(variant: str, embeddings, inference_config, sample: int):
    """Each bandwidth's ``(mask, X, X_fit, seeds, bandwidth)`` of a 2D
    sample as ``detect_sample`` prepares them with an Otsu threshold, for
    ``variant`` ``"meanshift"`` (bin seeds; device detect fits the same
    input), ``"seeds"`` (seeded, on the centred embeddings) or ``"sweep"``
    (one subsample draw for every bandwidth)."""
    ic = inference_config
    emb = np.asarray(embeddings, dtype=np.float32)
    mask = emb[-1] < threshold_otsu(emb[-1])
    centered = mean_center_embeddings(emb, mask)
    source = centered if variant == "seeds" else emb
    X = ms.add_coordinate_grid(source[:2]).reshape(2, -1).T[mask.ravel()]
    rng = sample_rng(ic.seed, sample)
    bandwidths = [ic.bandwidth / 2**k for k in range(ic.num_bandwidths)]
    if variant == "sweep":
        X_fit = ms.fit_subsample(X, ic.reduction_probability, rng)
        return [(mask, X, X_fit, ms.bin_seeds(X_fit, b), b) for b in bandwidths]
    seeds = (smooth_peak_seeds(np.linalg.norm(centered[:-1], axis=0), device="cpu")
             if variant == "seeds" else None)
    out = []
    for b in bandwidths:
        X_fit = ms.fit_subsample(X, ic.reduction_probability, rng)
        out.append((mask, X, X_fit, ms.bin_seeds(X_fit, b) if seeds is None else seeds, b))
    return out
