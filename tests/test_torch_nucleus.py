"""Nucleus post-processing of the port against the JAX package (CPU): the
host path (``nucleus_partition``) on fixtures with holes and a
constant-intensity instance, the device path
(``ops/nucleus.py:nucleus_partition_device``) against the JAX package's
device path exactly, a nested instance on which the two JAX paths differ,
and the whole segment stage on the JAX package's detections with the raw
image in a container of its own, by either path (the device one selected
by the config field or by ``CELLULUS_TPU_DEVICE_NUCLEUS``)."""

import numpy as np
import pytest
import torch

from cellulus_tpu.configs import InferenceConfig as JaxInferenceConfig
from cellulus_tpu.io import zarr
from cellulus_tpu.ops.nucleus import nucleus_partition_device as jax_nucleus_partition_device
from cellulus_tpu.segment import nucleus_partition as jax_nucleus_partition
from cellulus_tpu.segment import segment as jax_segment
from cellulus_tpu_torch.configs import InferenceConfig
from cellulus_tpu_torch.ops.nucleus import nucleus_partition_device
from cellulus_tpu_torch.segment import nucleus_partition, nucleus_segment_sample, segment


def _fixture(ndim, seed=0):
    """Labels and raw intensities: a bright ring around a dark core (Otsu
    keeps the ring, hole filling restores the core), a constant-intensity
    instance (kept whole), bimodal instances, a two-part instance, and
    noise outside."""
    rng = np.random.default_rng(seed)
    shape = (64, 72) if ndim == 2 else (20, 32, 36)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"))
    labels = np.zeros(shape, np.uint16)
    raw = rng.normal(0.1, 0.02, shape).astype(np.float32)
    centers = [np.array(shape) * f for f in (0.3, 0.55, 0.75)]
    radii = [0.2 * min(shape), 0.12 * min(shape), 0.15 * min(shape)]
    for i, (c, r) in enumerate(zip(centers, radii), start=1):
        dist = np.sqrt(((grid - c.reshape((-1,) + (1,) * ndim)) ** 2).sum(0))
        inside = (dist < r) & (labels == 0)
        labels[inside] = i
        if i == 1:  # ring: bright shell, dark core
            raw[inside] = np.where(dist[inside] > 0.5 * r, 0.9, 0.15)
        elif i == 2:  # constant intensity
            raw[inside] = 0.5
        else:  # bimodal: a bright half
            raw[inside] = np.where(grid[-1][inside] > c[-1], 0.8, 0.3) + rng.normal(
                0, 0.01, inside.sum())
    # an instance in two parts, one of them tiny
    labels[(slice(2, 6),) * ndim] = 4
    labels[(slice(-4, -2),) * ndim] = 4
    raw[labels == 4] = rng.uniform(0.2, 0.9, (labels == 4).sum())
    return labels, raw


@pytest.mark.parametrize("ndim", [2, 3])
def test_nucleus_partition_matches_jax(ndim):
    labels, raw = _fixture(ndim)
    got = nucleus_partition(labels, raw)
    np.testing.assert_array_equal(got, jax_nucleus_partition(labels, raw))
    assert got.dtype == labels.dtype
    # the ring's core came back by hole filling; the constant instance stayed whole
    assert (got == 1).sum() == (labels == 1).sum()
    assert (got == 2).sum() == (labels == 2).sum()
    assert 0 < (got == 3).sum() < (labels == 3).sum()


def _write(path, name, data, ndim):
    f = zarr.open(path, "a")
    f[name] = data
    f[name].attrs.update({"axis_names": ["s", "c"] + ["z", "y", "x"][-ndim:],
                          "resolution": [1] * ndim})


@pytest.mark.parametrize("ndim,min_size", [(2, 20), (2, 0), (3, 30)])
def test_segment_stage_matches_jax(tmp_path, ndim, min_size):
    """The segment stage in nucleus mode on the JAX package's detections
    (two samples, two bandwidths), the raw image in its own container
    (``cellulus_tpu/segment.py:222-230``): exactly equal labels."""
    samples = [_fixture(ndim, seed) for seed in (1, 2)]
    detections = np.stack([np.stack([l, np.where(l == 3, 0, l)]) for l, _ in samples])
    raw = np.stack([r[None] for _, r in samples])
    _write(tmp_path / "raw.zarr", "raw", raw, ndim)
    outputs = {}
    for name, Config, run in (("jax", JaxInferenceConfig, jax_segment),
                              ("port", InferenceConfig, lambda ic: segment(ic, "cpu"))):
        out = tmp_path / f"{name}.zarr"
        _write(out, "detection", detections.astype(np.uint16), ndim)
        ic = Config(
            dataset_config={"container_path": str(tmp_path / "raw.zarr"), "dataset_name": "raw"},
            segmentation_dataset_config={"container_path": str(out),
                                         "dataset_name": "segmentation",
                                         "secondary_dataset_name": "detection"},
            post_processing="nucleus", num_bandwidths=2, min_size=min_size,
            device_nucleus=False,
        )
        run(ic)
        outputs[name] = np.asarray(zarr.open(out, "r")["segmentation"][...])
    assert outputs["port"].shape == (2, 2) + samples[0][0].shape
    assert outputs["port"].max() > 0
    np.testing.assert_array_equal(outputs["port"], outputs["jax"])


def _nested(ndim):
    """Instance 1 a bright ring whose dark core holds instance 2 (constant
    intensity): the JAX host path fills the core with 1 around 2, its
    device path leaves the core's other pixels empty (their neighbours are
    {1, 2}, ``cellulus_tpu/ops/nucleus.py:22-28``)."""
    shape = (40, 44) if ndim == 2 else (24, 28, 30)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"))
    centre = (np.array(shape) / 2).reshape((-1,) + (1,) * ndim)
    dist = np.sqrt(((grid - centre) ** 2).sum(0))
    labels = np.zeros(shape, np.uint16)
    raw = np.random.default_rng(ndim).normal(0.1, 0.02, shape).astype(np.float32)
    labels[dist < 10] = 1
    raw[dist < 10] = np.where(dist[dist < 10] > 6, 0.9, 0.15)
    labels[dist < 3] = 2
    raw[dist < 3] = 0.5
    return labels, raw


def _device(labels, raw):
    return nucleus_partition_device(torch.from_numpy(labels.astype(np.int32)),
                                    torch.from_numpy(raw)).numpy()


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_nucleus_matches_jax_device_path(ndim, seed):
    labels, raw = _fixture(ndim, seed)
    got = _device(labels, raw)
    np.testing.assert_array_equal(got, jax_nucleus_partition_device(labels, raw))
    # without nesting, the device path gives the host path's labels
    np.testing.assert_array_equal(got, jax_nucleus_partition(labels, raw))


@pytest.mark.parametrize("ndim", [2, 3])
def test_nested_instance_follows_the_jax_device_path(ndim):
    labels, raw = _nested(ndim)
    want = jax_nucleus_partition_device(labels, raw)
    host = jax_nucleus_partition(labels, raw)
    assert (want != host).any()  # the fixture nests
    got = _device(labels, raw)
    np.testing.assert_array_equal(got, want)
    # the differing pixels are the core around instance 2, empty here
    core = (host != want)
    assert (got[core] == 0).all() and (host[core] == 1).all()
    np.testing.assert_array_equal(nucleus_segment_sample(labels, raw, 0, "cpu"),
                                  want.astype(np.uint16))


@pytest.mark.parametrize("field,env", [(True, None), (None, "1")])
def test_device_nucleus_stage_matches_jax(tmp_path, monkeypatch, field, env):
    """The segment stage with ``device_nucleus`` from the config or from
    ``CELLULUS_TPU_DEVICE_NUCLEUS`` against the JAX package's stage with the
    same setting (``tests/test_pipeline.py:275-375``): two samples, two
    bandwidths, a nested instance, min_size 20. Exactly equal labels."""
    samples = [_fixture(2, 3), _nested(2)]
    shape = samples[0][0].shape
    detections = np.zeros((2, 2) + shape, np.uint16)
    raw = np.zeros((2, 1) + shape, np.float32)
    for i, (labels, image) in enumerate(samples):
        h, w = labels.shape
        detections[i, :, :h, :w] = labels
        detections[i, 1][detections[i, 1] == 3] = 0
        raw[i, 0, :h, :w] = image
    _write(tmp_path / "raw.zarr", "raw", raw, 2)
    if env is not None:
        monkeypatch.setenv("CELLULUS_TPU_DEVICE_NUCLEUS", env)
    outputs = {}
    for name, Config, run in (("jax", JaxInferenceConfig, jax_segment),
                              ("port", InferenceConfig, lambda ic: segment(ic, "cpu"))):
        out = tmp_path / f"{name}.zarr"
        _write(out, "detection", detections, 2)
        ic = Config(
            dataset_config={"container_path": str(tmp_path / "raw.zarr"), "dataset_name": "raw"},
            segmentation_dataset_config={"container_path": str(out),
                                         "dataset_name": "segmentation",
                                         "secondary_dataset_name": "detection"},
            post_processing="nucleus", num_bandwidths=2, min_size=20, device_nucleus=field,
        )
        run(ic)
        outputs[name] = np.asarray(zarr.open(out, "r")["segmentation"][...])
    np.testing.assert_array_equal(outputs["port"], outputs["jax"])
    # the nested sample took the device path: its core stays empty
    labels, image = samples[1]
    h, w = labels.shape
    host = jax_nucleus_partition(labels, image)
    assert (outputs["port"][1, 0, :h, :w][host != jax_nucleus_partition_device(labels, image)]
            == 0).all()
