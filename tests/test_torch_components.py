"""Connected components on the device (``cellulus_tpu_torch/ops/components.py``)
against the JAX package's (``cellulus_tpu/ops/components.py``), exactly, on
the CPU: ``cc_parents`` in 2D and 3D with full and axis connectivity,
``filter_relabel_device``, the size filter against ``size_filter`` and the
scipy oracles, a spiral (the most rounds), empty input, ``min_size = 0``, a
hypothesis case of random label images, and ``cell_segment_sample``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra.numpy import arrays

from cellulus_tpu.ops import components as jax_components
from cellulus_tpu.segment import cell_segment_sample as jax_cell_segment_sample
from cellulus_tpu_torch.ops.components import (
    cc_parents,
    filter_relabel,
    filter_relabel_device,
    size_filter_device,
)
from cellulus_tpu_torch.segment import cell_segment_sample

SHAPES = {2: (40, 52), 3: (12, 18, 20)}


def _labels(shape, seed, ids=4, fill=0.6):
    """Random ids, touching each other (components of different ids stay
    apart), with background holes."""
    rng = np.random.default_rng(seed)
    return (rng.integers(1, ids + 1, shape) * (rng.random(shape) < fill)).astype(np.int32)


def _blobs(shape, seed, count=9):
    """Overlapping balls of random ids: larger components, a few of them
    split by later balls."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"))
    out = np.zeros(shape, np.int32)
    for i in range(count):
        centre = rng.uniform(0, shape).reshape((-1,) + (1,) * len(shape))
        radius = rng.uniform(2, 0.3 * min(shape))
        out[((grid - centre) ** 2).sum(0) < radius**2] = rng.integers(1, 6)
    return out


def spiral(size=41):
    """A one-pixel-wide square spiral, rings 2 pixels apart: one component
    that turns at every ring, the worst case for the rounds."""
    out = np.zeros((size, size), np.int32)
    t, l, b, r = 0, 0, size - 1, size - 1
    while r - l >= 2 and b - t >= 2:
        out[t, l:r + 1] = 1
        out[t:b + 1, r] = 1
        out[b, l:r + 1] = 1
        out[t + 2:b + 1, l] = 1
        out[t + 2, l:l + 3] = 1  # into the next ring
        t, l, b, r = t + 2, l + 2, b - 2, r - 2
    return out


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("make", [_labels, _blobs])
def test_cc_parents_match_jax(ndim, full, make):
    values = make(SHAPES[ndim], seed=ndim)
    want = np.asarray(jax_components.cc_parents(jnp.asarray(values), full_connectivity=full))
    got = cc_parents(torch.from_numpy(values), full_connectivity=full)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_spiral_resolves_to_one_component():
    values = spiral()
    stats = {}
    parents = cc_parents(torch.from_numpy(values), stats=stats).numpy()
    want = np.asarray(jax_components.cc_parents(jnp.asarray(values)))
    np.testing.assert_array_equal(parents, want)
    assert set(np.unique(parents[values > 0])) == {0}
    # the convergence check runs every CHECK_EVERY rounds
    assert stats["rounds"] > 4 and stats["rounds"] % 4 == 0
    np.testing.assert_array_equal(size_filter_device(torch.from_numpy(values), 1).numpy(),
                                  jax_components.label_host(values))


@pytest.mark.parametrize("ndim", [2, 3])
def test_empty_input(ndim):
    values = np.zeros(SHAPES[ndim], np.int32)
    parents = cc_parents(torch.from_numpy(values)).numpy()
    assert (parents == values.size).all()
    labels = size_filter_device(torch.from_numpy(values), 5)
    assert labels.dtype == torch.uint16 and not labels.numpy().any()


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("min_size", [0, 1, 6, 40])
def test_size_filter_matches_jax(ndim, min_size):
    """``size_filter_device`` against the JAX package's ``size_filter`` and,
    for ``min_size > 0``, the scipy oracles (``filter_relabel`` and
    ``label_host``); ``min_size = 0`` keeps the labels as they are."""
    values = _blobs(SHAPES[ndim], seed=10 + ndim)
    got = size_filter_device(torch.from_numpy(values), min_size)
    assert got.dtype == torch.uint16
    got = got.numpy().astype(np.int64)
    np.testing.assert_array_equal(got, jax_components.size_filter(values, min_size))
    if min_size == 0:
        np.testing.assert_array_equal(got, values)
    else:
        np.testing.assert_array_equal(got, filter_relabel(values, min_size))
    if min_size == 1:
        np.testing.assert_array_equal(got, jax_components.label_host(values))


@pytest.mark.parametrize("min_size", [1, 7])
def test_filter_relabel_device_matches_jax(min_size):
    """The epilogue alone, on the JAX package's parents."""
    values = _labels(SHAPES[2], seed=5, ids=3, fill=0.5)
    parents = np.array(jax_components.cc_parents(jnp.asarray(values))).ravel()
    at_parent = np.concatenate([values.ravel(), [0]])[parents]
    want = np.asarray(jax_components.filter_relabel_device(
        jnp.asarray(parents), jnp.asarray(at_parent), min_size))
    got = filter_relabel_device(torch.from_numpy(parents).long(), torch.from_numpy(at_parent),
                                min_size)
    assert got.dtype == torch.uint16 and want.dtype == np.uint16
    np.testing.assert_array_equal(got.numpy(), want)


@settings(max_examples=40, deadline=None)
@given(values=arrays(np.int32, (9, 11), elements=st.integers(0, 3)),
       min_size=st.integers(0, 6))
def test_random_label_images_match_jax(values, min_size):
    got = size_filter_device(torch.from_numpy(values), min_size).numpy().astype(np.int64)
    np.testing.assert_array_equal(got, jax_components.size_filter(values, min_size))


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("min_size", [0, 20])
def test_cell_segment_sample_matches_jax(ndim, min_size):
    """Halo removal, CC, size filter and relabel in one pass on the device
    against the JAX package's one dispatch, exactly, in the input's dtype."""
    detections = _blobs(SHAPES[ndim], seed=20 + ndim).astype(np.uint16)
    got = cell_segment_sample(detections, 2, 3, min_size, "cpu")
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, jax_cell_segment_sample(detections, 2, 3, min_size))
