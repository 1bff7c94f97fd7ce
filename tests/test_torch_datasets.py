"""The port's data pipeline against the JAX package's: the same seed gives
bit-equal crops and pairs; the torch device sampler draws from the pair
distribution."""

import numpy as np
import pytest
import torch

from cellulus_tpu.configs import DatasetConfig as JaxDatasetConfig
from cellulus_tpu.datasets import BatchLoader as JaxBatchLoader
from cellulus_tpu.datasets import get_dataset as jax_get_dataset
from cellulus_tpu.datasets.elastic import elastic_deform as jax_elastic_deform
from cellulus_tpu.datasets.sampling import PairSampler as JaxPairSampler
from cellulus_tpu_torch.configs import DatasetConfig
from cellulus_tpu_torch.datasets import BatchLoader, PairSampler, get_dataset
from cellulus_tpu_torch.datasets.elastic import elastic_deform


def _kwargs(elastic):
    return dict(crop_size=(60, 60), elastic_deform=elastic, control_point_spacing=16,
                control_point_jitter=2.0, density=0.1, kappa=5.0, normalization_factor=None,
                output_shape=(44, 44), seed=3)


@pytest.mark.parametrize("elastic", [False, True])
def test_crops_and_pairs_are_bit_equal(blob_container_2d, elastic):
    cfg = {"container_path": str(blob_container_2d), "dataset_name": "train"}
    mine = get_dataset(DatasetConfig(**cfg), **_kwargs(elastic)).iterate(11)
    ref = jax_get_dataset(JaxDatasetConfig(**cfg), **_kwargs(elastic)).iterate(11)
    for _ in range(4):
        for a, b in zip(next(mine), next(ref)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_batch_loader_is_bit_equal(blob_container_2d):
    cfg = {"container_path": str(blob_container_2d), "dataset_name": "train"}
    kw = dict(_kwargs(False), sample_pairs=False)
    with BatchLoader(get_dataset(DatasetConfig(**cfg), **kw), 3, num_workers=2) as mine, \
            JaxBatchLoader(jax_get_dataset(JaxDatasetConfig(**cfg), **kw), 3,
                           num_workers=2) as ref:
        for a, b in zip(iter(mine), iter(ref)):
            assert len(a) == len(b) == 1
            np.testing.assert_array_equal(a[0], b[0])
            break


def test_elastic_warp_and_host_pairs_are_bit_equal():
    padded = np.random.default_rng(0).random((1, 90, 90)).astype(np.float32)
    np.testing.assert_array_equal(
        elastic_deform(padded, (60, 60), 16, 2.0, np.random.default_rng(1)),
        jax_elastic_deform(padded, (60, 60), 16, 2.0, np.random.default_rng(1)),
    )
    for a, b in zip(PairSampler((44, 50), 0.1, 5.0).sample(np.random.default_rng(2)),
                    JaxPairSampler((44, 50), 0.1, 5.0).sample(np.random.default_rng(2))):
        np.testing.assert_array_equal(a, b)


def test_device_sampler_draws_pairs_in_the_disk():
    sampler = PairSampler((40, 52), density=0.1, kappa=5.0)  # (H, W): x < 52, y < 40
    sample = sampler.device_sampler_grouped("cpu")
    anchors, references = sample(torch.Generator().manual_seed(0), 3)
    A, R = sampler.n_anchors, sampler.n_references
    assert anchors.shape == (3, A, 2) and references.shape == (3, A, R, 2)
    a = anchors.numpy()
    assert a[..., 0].min() >= 5 and a[..., 0].max() <= 52 - 5
    assert a[..., 1].min() >= 5 and a[..., 1].max() <= 40 - 5
    assert a[..., 0].max() > 40  # x runs over the wider axis
    offsets = (references - anchors[:, :, None, :]).reshape(-1, 2).numpy()
    lattice = {tuple(o) for o in sampler._offsets.tolist()}
    assert {tuple(o) for o in offsets.tolist()} <= lattice
    assert len({tuple(o) for o in offsets.tolist()}) > 0.9 * len(lattice)
    again = sample(torch.Generator().manual_seed(0), 3)
    torch.testing.assert_close(again[0], anchors, rtol=0, atol=0)
    torch.testing.assert_close(again[1], references, rtol=0, atol=0)
    other = sample(torch.Generator().manual_seed(1), 3)
    assert not torch.equal(other[0], anchors)
