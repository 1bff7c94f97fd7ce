"""The port's mean shift (CPU) against the JAX package's and sklearn's, on
the fixtures of tests/test_ops.py."""

import numpy as np
import pytest

from cellulus_tpu.ops.mean_shift import mean_shift_fit_predict as jax_fit_predict
from cellulus_tpu.ops.mean_shift import mean_shift_segmentation as jax_segmentation
from cellulus_tpu_torch.ops.mean_shift import (
    mean_shift_fit_predict,
    mean_shift_segmentation,
)


def _same_partition(a, b):
    """Equal up to a permutation of ids, with the same orphan set."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not ((a == -1) == (b == -1)).all():
        return False
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("seeded", [False, True])
def test_mean_shift_matches_jax_and_sklearn(seeded):
    sklearn_cluster = pytest.importorskip("sklearn.cluster")
    rng = np.random.default_rng(1)
    centers = np.array([[0.0, 0.0], [8.0, 8.0], [0.0, 9.0]])
    X = np.concatenate([rng.normal(c, 0.6, size=(60, 2)) for c in centers]).astype(np.float32)
    X = np.concatenate([X, np.array([[30.0, 30.0], [-25.0, 4.0]], np.float32)])
    bandwidth = 2.0
    seeds = centers + 0.3 if seeded else None

    ref = sklearn_cluster.MeanShift(
        bandwidth=bandwidth, cluster_all=False, seeds=seeds
    ).fit_predict(X)
    jax_labels = jax_fit_predict(X, bandwidth=bandwidth, seeds=seeds, reduction_probability=1.0)
    mine = mean_shift_fit_predict(
        X, bandwidth=bandwidth, seeds=seeds, reduction_probability=1.0, device="cpu"
    )
    assert _same_partition(mine, jax_labels)
    assert _same_partition(mine, ref)
    # ids too: all three sort centers by population
    np.testing.assert_array_equal(mine, ref)


def test_mean_shift_orphans_get_minus_one():
    X = np.array([[0.0, 0.0], [0.1, 0.0], [50.0, 50.0]], np.float32)
    seeds = np.array([[0.0, 0.0]], np.float32)
    mine = mean_shift_fit_predict(X, bandwidth=1.0, seeds=seeds, device="cpu")
    np.testing.assert_array_equal(mine, [0, 0, -1])
    np.testing.assert_array_equal(mine, jax_fit_predict(X, bandwidth=1.0, seeds=seeds))


def test_mean_shift_subsample_and_max_iter_match_jax():
    """Fit on a reduction_probability subsample drawn from the same numpy
    stream, with seeds still live at max_iter (the recount path)."""
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 60, size=(4000, 2)).astype(np.float32)
    kwargs = dict(bandwidth=2.5, seeds=None, reduction_probability=0.3, max_iter=3)
    mine = mean_shift_fit_predict(X, rng=np.random.default_rng([0, 1]), device="cpu", **kwargs)
    ref = jax_fit_predict(X, rng=np.random.default_rng([0, 1]), **kwargs)
    assert _same_partition(mine, ref)


def test_mean_shift_segmentation_on_synthetic_embeddings():
    """Pixels pointing at two distinct centers split into two instances."""
    h = w = 32
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    offset = np.zeros((2, h, w), np.float32)
    std = np.ones((h, w), np.float32)
    for cy, cx in [(8, 8), (24, 24)]:
        mask = (np.abs(yy - cy) <= 4) & (np.abs(xx - cx) <= 4)
        offset[0][mask] = cx - xx[mask]
        offset[1][mask] = cy - yy[mask]
        std[mask] = 0.1
    kwargs = dict(bandwidth=3.0, reduction_probability=1.0, threshold=0.5)
    seg = mean_shift_segmentation(offset, std, device="cpu", **kwargs)
    ref = jax_segmentation(offset, std, min_size=0, seeds=None, **kwargs)
    assert seg.shape == (h, w)
    ids = np.unique(seg)
    assert len(ids[ids > 0]) == 2
    assert seg[8, 8] != seg[24, 24]
    assert seg[0, 31] == 0
    assert _same_partition(seg.ravel() - 1, ref.ravel() - 1)
