"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference works out, each held to a limit of
its own (the cell's workload file holds the limits)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def rel_gap(got: np.ndarray, want: np.ndarray) -> float:
    """``|got - want| / |want|`` over the whole array (L2 norms)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def rms_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The root-mean-square gap: for offsets, the embeddings' error in
    pixels, the scale detect's bandwidth is set in. (A relative gap would
    swing with the reference's own magnitude, which random weights make
    anything from 0.1 to 1 pixel.)"""
    gap = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return float(np.sqrt((gap * gap).mean()))


def canonical(labels: np.ndarray) -> np.ndarray:
    """Labels renumbered 1, 2, .. by the raster order of each label's first
    pixel (0 stays 0): two label images of one partition become equal."""
    flat = np.asarray(labels).ravel()
    ids, first = np.unique(flat, return_index=True)
    keep = ids != 0
    ids, first = ids[keep], first[keep]
    rank = np.empty(len(ids), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(1, len(ids) + 1)
    out = np.zeros(flat.shape, np.int64)
    if len(ids):
        pos = np.searchsorted(ids, flat)
        pos = np.clip(pos, 0, len(ids) - 1)
        hit = ids[pos] == flat
        out[hit] = rank[pos[hit]]
    return out.reshape(np.shape(labels))


def label_px(got: np.ndarray, want: np.ndarray) -> int:
    """Pixels whose label differs once both partitions are renumbered."""
    return int((canonical(got) != canonical(want)).sum())


def partition_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The share of the pixels labelled on either side that lie outside
    their label's largest overlap with a label of the other side (0 counts
    as a label), in the worse of the two directions."""
    a = np.asarray(got).ravel().astype(np.int64)
    b = np.asarray(want).ravel().astype(np.int64)
    sel = (a != 0) | (b != 0)
    n = int(sel.sum())
    if n == 0:
        return 0.0
    a, b = a[sel], b[sel]
    pairs, counts = np.unique(np.stack([a, b]), axis=1, return_counts=True)
    worst = 0.0
    for side in (0, 1):
        best: Dict[int, int] = {}
        for key, c in zip(pairs[side].tolist(), counts.tolist()):
            if c > best.get(key, 0):
                best[key] = c
        worst = max(worst, 1.0 - sum(best.values()) / n)
    return worst


def _leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], names):
    g = np.array([float(torch.linalg.vector_norm(got[n].double())) for n in names])
    w = np.array([float(torch.linalg.vector_norm(want[n].double())) for n in names])
    scale = np.maximum(w, np.median(w))
    return np.abs(g - w) / np.maximum(scale, 1e-30)


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], names) -> float:
    """The worst leaf's gap between the norms of ``got`` and ``want``,
    against the larger of that leaf's reference norm and the median leaf's."""
    return float(np.max(_leaf_gaps(got, want, names))) if len(names) else 0.0


def worst_leaf(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], names) -> str:
    """The name of the leaf :func:`leaf_gaps` reads."""
    return names[int(np.argmax(_leaf_gaps(got, want, names)))] if len(names) else ""


def check(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number passes at or below it."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name)
        out[name] = {"value": value, "limit": limit,
                     "ok": value is not None and np.isfinite(value) and value <= limit}
    return out
