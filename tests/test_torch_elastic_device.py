"""Elastic augmentation on the device, and the dataset's padded and native
reads, against the JAX package (CPU): the resize, the deformation grid and
the reflect-boundary sampling for given parameters in 2D and 3D, the padded
and native crops, the shared native scale, and the two invalid
combinations ``train()`` refuses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cellulus_tpu_torch
from cellulus_tpu.configs import DatasetConfig as JaxDatasetConfig
from cellulus_tpu.datasets import elastic as jax_host_elastic
from cellulus_tpu.datasets import elastic_jax
from cellulus_tpu.datasets import get_dataset as jax_get_dataset
from cellulus_tpu_torch.configs import DatasetConfig, ExperimentConfig
from cellulus_tpu_torch.datasets import ConcatDataset, get_dataset
from cellulus_tpu_torch.datasets.elastic import required_margin
from cellulus_tpu_torch.datasets.elastic_device import (
    _reflect_index,
    deformation_grid,
    elastic_deform_batch,
    elastic_deform_device,
    map_coordinates_linear,
    resize_linear,
)
from cellulus_tpu_torch.train import _prep_raw


@pytest.mark.parametrize("src,dst", [
    ((3,), (19,)),            # crop 76, spacing 64: control points -> subsampled grid
    ((19,), (76,)),           # subsampled grid -> crop
    ((2, 3, 3), (10, 19, 19)),  # 3D, crop (40, 76, 76)
    ((5, 5), (63, 63)),       # crop 252
    ((9, 4), (4, 9)),         # down along one axis (the kernel widens), up along the other
    ((40,), (7,)),
])
def test_resize_matches_jax_image_resize(src, dst):
    """``jax.image.resize(..., "linear")`` at the control-point shapes and in
    both directions, edges included: within 2 float32 ulps of values of
    order 1 (atol 3e-7; the contraction order differs)."""
    x = np.random.default_rng(0).standard_normal((2, *src)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst), "linear"))
    got = resize_linear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-7)
    # the edges: the first and last outputs clamp to the first and last inputs
    if all(d > s for s, d in zip(src, dst)):
        np.testing.assert_allclose(got[(slice(None),) + (0,) * len(src)],
                                   x[(slice(None),) + (0,) * len(src)], atol=3e-7)


def _parameters(ndim, jitter, seed=0):
    rng = np.random.default_rng(seed)
    crop = (24, 28) if ndim == 2 else (12, 20, 24)
    margin = required_margin(crop, jitter)
    padded = tuple(c + 2 * margin for c in crop)
    n_cp = tuple(max(2, int(np.ceil(s / 16)) + 1) for s in crop)
    cps = (rng.normal(0, jitter, size=(ndim, *n_cp)).astype(np.float32) if jitter else None)
    return crop, padded, np.float32(0.7), np.float32(1.05), cps, rng


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("jitter", [0.0, 2.0])
def test_deformation_grid_matches_jax(ndim, jitter):
    """Given rotation, scale and control points, the sample grid equals
    ``elastic_jax.deformation_grid`` within float32 rounding of coordinates
    below 128 (atol 2e-5; the two ``cos``/``sin`` may differ by an ulp)."""
    crop, padded, rotation, scale, cps, _ = _parameters(ndim, jitter)
    want = np.asarray(elastic_jax.deformation_grid(
        crop, padded, jnp.float32(rotation), jnp.float32(scale),
        None if cps is None else jnp.asarray(cps)))
    got = deformation_grid(crop, padded, torch.tensor(rotation), torch.tensor(scale),
                           None if cps is None else torch.from_numpy(cps)).numpy()
    assert got.shape == (ndim, *crop)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    # batched parameters give each element its own grid
    batched = deformation_grid(crop, padded, torch.tensor([rotation, 0.1]),
                               torch.tensor([scale, 0.95]),
                               None if cps is None else torch.from_numpy(np.stack([cps, cps])))
    np.testing.assert_array_equal(batched[0].numpy(), got)


@pytest.mark.parametrize("ndim", [2, 3])
def test_map_coordinates_reflect_edges_match_jax(ndim):
    """Sample positions well outside the padded source on every side (the
    reflect folding, periods and all) give ``elastic_jax``'s values bit for
    bit: the same corner order and weight products."""
    rng = np.random.default_rng(1)
    shape = (17, 23) if ndim == 2 else (9, 11, 13)
    out = (20, 30) if ndim == 2 else (6, 8, 10)
    image = rng.random(shape).astype(np.float32)
    grid = np.stack([rng.uniform(-2.5 * s, 3.5 * s, size=out) for s in shape]).astype(np.float32)
    want = np.asarray(elastic_jax.map_coordinates_linear(jnp.asarray(image), jnp.asarray(grid)))
    got = map_coordinates_linear(torch.from_numpy(image)[None, ..., None],
                                 torch.from_numpy(grid)[None])[0, ..., 0].numpy()
    np.testing.assert_array_equal(got, want)
    idx = torch.arange(-40, 40)
    np.testing.assert_array_equal(_reflect_index(idx, 7).numpy(),
                                  np.asarray(elastic_jax._reflect_index(jnp.arange(-40, 40), 7)))


@pytest.mark.parametrize("jitter", [0.0, 2.0])
def test_device_warp_matches_scipy(jitter):
    """The port's warp against the host (scipy) warp given the same
    parameters, as ``tests/test_elastic_jax.py`` holds the JAX one
    (atol 2e-3: scipy's zoom and map_coordinates round in float64)."""
    crop, padded_shape, rotation, scale, cps, rng = _parameters(2, jitter)
    padded = rng.random((1, *padded_shape)).astype(np.float32)

    class Draws:
        def __init__(self):
            self.uniforms = [float(rotation), float(scale)]
            self.normals = [] if cps is None else list(cps)

        def uniform(self, lo, hi):
            return self.uniforms.pop(0)

        def normal(self, mean, std, size):
            return self.normals.pop(0)

    n_cp = tuple(max(2, int(np.ceil(s / 16)) + 1) for s in crop)
    if cps is not None:
        assert cps.shape[1:] == n_cp
    host = jax_host_elastic.elastic_deform(padded, crop, 16, jitter, Draws())
    grid = deformation_grid(crop, padded_shape, torch.tensor(rotation), torch.tensor(scale),
                            None if cps is None else torch.from_numpy(cps))
    got = map_coordinates_linear(torch.from_numpy(padded[0])[None, ..., None], grid[None])
    np.testing.assert_allclose(got[0, ..., 0].numpy(), host[0], atol=2e-3)


def test_batch_deform_draws_per_element_from_the_generator():
    """Each batch element gets its own deformation; the same generator seed
    gives the same batch; the single-crop form is channels-first."""
    crop = (20, 20)
    margin = required_margin(crop, 2.0)
    rng = np.random.default_rng(2)
    padded = torch.from_numpy(
        rng.random((3, crop[0] + 2 * margin, crop[1] + 2 * margin, 2)).astype(np.float32))
    padded[1] = padded[0]
    fn = elastic_deform_batch(crop, 10, 2.0)
    a = fn(padded, torch.Generator().manual_seed(3))
    b = fn(padded, torch.Generator().manual_seed(3))
    assert a.shape == (3, *crop, 2) and a.dtype == torch.float32
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a[0], a[1])  # same input, different deformation
    one = elastic_deform_device(padded[0].permute(2, 0, 1), crop, 10, 2.0,
                                torch.Generator().manual_seed(3))
    first = fn(padded[:1], torch.Generator().manual_seed(3))[0]
    torch.testing.assert_close(one, first.permute(2, 0, 1), rtol=0, atol=0)


def _dataset_kwargs(**overrides):
    kw = dict(crop_size=(36, 40), elastic_deform=True, control_point_spacing=16,
              control_point_jitter=2.0, density=0.1, kappa=5.0, normalization_factor=None,
              output_shape=(20, 24), seed=3, sample_pairs=False)
    kw.update(overrides)
    return kw


@pytest.mark.parametrize("normalize", [True, False])
def test_padded_crops_equal_the_jax_datasets(blob_container_2d, normalize):
    """``elastic_device`` reads padded crops (crop + 2 x margin per axis),
    bit-equal to the JAX dataset's when normalized; in source units the port
    keeps the source dtype, whose values equal the JAX dataset's float32
    source units exactly."""
    cfg = {"container_path": str(blob_container_2d), "dataset_name": "train"}
    kw = _dataset_kwargs(elastic_device=True, normalize=normalize)
    mine = get_dataset(DatasetConfig(**cfg), **kw)
    ref = jax_get_dataset(JaxDatasetConfig(**cfg), **kw)
    margin = required_margin((36, 40), 2.0)
    a_it, b_it = mine.iterate(5), ref.iterate(5)
    for _ in range(3):
        (a,), (b,) = next(a_it), next(b_it)
        assert a.shape == (1, 36 + 2 * margin, 40 + 2 * margin)
        assert a.dtype == (np.float32 if normalize else np.uint8)
        np.testing.assert_array_equal(a.astype(b.dtype), b)


def test_native_crops_times_scale_equal_the_float32_path(blob_container_2d):
    """Native crops ship in the source dtype (uint8 here: a quarter of the
    float32 path's bytes), and normalized by the step's ``_prep_raw`` in
    float32 they are bit-equal to the float32 path's crops: both are one
    float32 product of the same values."""
    cfg = DatasetConfig(container_path=str(blob_container_2d), dataset_name="train")
    native = get_dataset(cfg, **_dataset_kwargs(elastic_deform=False, normalize=False))
    plain = get_dataset(cfg, **_dataset_kwargs(elastic_deform=False))
    n_it, p_it = native.iterate(7), plain.iterate(7)
    for _ in range(4):
        (n,), (p,) = next(n_it), next(p_it)
        assert n.dtype == np.uint8 and n.max() > 1 and 4 * n.nbytes == p.nbytes
        got = _prep_raw(torch.from_numpy(n), native.normalization_factor, torch.float32)
        np.testing.assert_array_equal(got.numpy(), p)


def test_native_scale_is_shared_by_the_datasets(blob_container_2d, tmp_path):
    cfg = DatasetConfig(container_path=str(blob_container_2d), dataset_name="train")
    kw = _dataset_kwargs(elastic_deform=False, normalize=False)
    same = ConcatDataset([get_dataset(cfg, **kw), get_dataset(cfg, **kw)])
    assert same.normalization_factor == 1.0 / 255
    other = get_dataset(cfg, **dict(kw, normalization_factor=0.5))
    with pytest.raises(ValueError, match="share one normalization factor"):
        ConcatDataset([get_dataset(cfg, **kw), other]).normalization_factor


def _train_config(container, **train):
    return ExperimentConfig(**{
        "object_size": 10,
        "model_config": {"num_fmaps": 8, "fmap_inc_factor": 2, "features_in_last_layer": 16},
        "train_config": {"device": "cpu", "crop_size": [60, 60], "batch_size": 2,
                         "kappa": 5.0, "max_iterations": 1, "num_workers": 1,
                         "train_data_config": {"container_path": str(container),
                                               "dataset_name": "train"},
                         **train},
    })


@pytest.mark.parametrize("train,match", [
    # native transfer with the host warp
    ({"transfer_precision": "native", "elastic_deform": True}, "requires host elastic off"),
    # the device warp without a key-driven step
    ({"elastic_deform": True, "elastic_on_device": True, "device_pair_sampling": False},
     "needs a key-driven step"),
])
def test_invalid_combinations_raise_as_jax(blob_container_2d, tmp_path, monkeypatch, train,
                                           match):
    """The JAX package's two ValueErrors (``cellulus_tpu/train.py:683-705``)."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match=match):
        cellulus_tpu_torch.train(_train_config(blob_container_2d, **train))
