"""The spatially sharded forward (``parallel/spatial.py``) against the JAX
package's (``cellulus_tpu/parallel/spatial.py``) on the CPU: its plans over
a grid of shapes, the sharded forward over 2 and 4 devices (N times
``cpu`` here, the JAX package's forced host devices there), and
``spatial_shards = 2`` through ``infer()`` against the tiled path at
``p_salt_pepper = 0``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cellulus_tpu_torch
import chip_smoke
from cellulus_tpu.parallel import spatial as jax_spatial
from cellulus_tpu_torch.io import zarr
from cellulus_tpu_torch.parallel import spatial
from tests.unet_pairs import unet_pair

MODELS = {
    "2d-one-level": (2, [[2, 2]]),
    "2d-two-levels": (2, [[2, 2], [2, 2]]),
    "3d": (3, [[1, 2, 2]]),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the cases are small, and test workers run side
    by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same(mine, want, *args):
    """``mine(*args)`` equals ``want(*args)``, or both raise ValueError (an
    extent no valid-conv geometry reaches)."""
    try:
        expected = want(*args)
    except ValueError:
        with pytest.raises(ValueError):
            mine(*args)
        return
    assert mine(*args) == expected, args


@pytest.mark.parametrize("name", sorted(MODELS))
def test_spatial_plans_match_jax(name):
    """``plan_spatial_split``, ``plan_whole_sample`` and the per-axis halo
    and pad of the port equal the JAX package's (or both raise), shard
    counts 2-4."""
    ndim, factors = MODELS[name]
    spec, _, model = unet_pair(ndim, factors)
    shapes = {2: [(100, 60), (61, 57), (512, 512), (33, 200)],
              3: [(20, 36, 44), (48, 48, 48), (17, 60, 31)]}[ndim]
    for n in (2, 3, 4):
        for min_h in (8, 12):
            _same(lambda m: spatial.plan_spatial_split(model, n, m),
                  lambda m: jax_spatial.plan_spatial_split(spec, n, m), min_h)
        for shape in shapes:
            _same(lambda s: spatial.plan_whole_sample(model, s, n),
                  lambda s: jax_spatial.plan_whole_sample(spec, s, n), shape)
        for h_local in (10, 16, 23):
            _same(lambda h: spatial._axis_context(model, h, n),
                  lambda h: jax_spatial._axis_context(spec, h, n), h_local)
    for axis in range(1, ndim):
        for extent in (36, 57, 100):
            _same(lambda e: spatial._axis_pad_for_output(model, axis, e),
                  lambda e: jax_spatial._axis_pad_for_output(spec, axis, e), extent)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_forward_matches_jax(n_shards):
    """The port's sharded forward over ``n_shards`` CPU devices equals the JAX
    package's over its mesh and the port's unsharded forward of the input
    reflect-padded by the halo (atol 1e-5)."""
    spec, params, model = unet_pair(2, [[2, 2]])
    H, context = spatial.plan_spatial_split(model, n_shards, min_h_local=12)
    raw = np.random.default_rng(0).normal(size=(1, H, 60, 1)).astype(np.float32)
    mine = spatial.sharded_forward(model, torch.from_numpy(raw), ["cpu"] * n_shards).numpy()
    want = np.asarray(jax_spatial.sharded_forward(
        spec, params, jnp.asarray(raw), jax_spatial.make_spatial_mesh(n_shards)))
    padded = np.pad(raw, ((0, 0), (context, context), (0, 0), (0, 0)), mode="reflect")
    with torch.no_grad():
        whole = model(torch.from_numpy(padded)).numpy()
    assert mine.shape == want.shape == whole.shape
    np.testing.assert_allclose(mine, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mine, whole, atol=1e-5, rtol=0)


def test_sharded_forward_rejects_uneven_split():
    _, _, model = unet_pair(2, [[2, 2]])
    with pytest.raises(ValueError, match="does not split"):
        spatial.sharded_forward(model, torch.zeros(1, 30, 60, 1), ["cpu"] * 4)


def test_exchange_halo_reflects_at_the_edges():
    x = torch.arange(12.0).reshape(1, 12, 1)
    shards = spatial.exchange_halo(list(torch.split(x, 4, dim=1)), 2, dim=1)
    full = np.pad(np.arange(12.0), 2, mode="reflect")
    for i, s in enumerate(shards):
        np.testing.assert_array_equal(s.reshape(-1).numpy(), full[4 * i : 4 * i + 8])


def test_spatial_shards_infer_equals_tiled(tmp_path, monkeypatch):
    """``spatial_shards = 2`` (each sample one forward over 2 CPU devices)
    and the tiled path, at ``p_salt_pepper = 0`` where every TTA copy is the
    input: the same embeddings (atol 1e-5: the shards' convolutions run at
    other shapes) and, downstream, the same segmentation
    (``tests/test_spatial_sharding.py:62``)."""
    monkeypatch.chdir(tmp_path)
    model = dict(num_fmaps=6, fmap_inc_factor=2, features_in_last_layer=8,
                 downsampling_factors=[[2, 2]])
    chip_smoke.save_random_checkpoint("w.pth", seed=2, **model)
    out = {}
    for shards in (0, 2):
        container = chip_smoke.write_blob_container(f"data{shards}.zarr", 2, 96, seed=3)
        config = chip_smoke.infer_config(container, "w.pth", model, object_size=10,
                                         device="cpu", crop_size=[60, 60],
                                         num_infer_iterations=2, p_salt_pepper=0.0,
                                         mean_shift_max_iterations=30, spatial_shards=shards,
                                         # the std channel is 0 without noise: a fixed
                                         # threshold keeps every pixel as foreground
                                         threshold=0.5)
        cellulus_tpu_torch.infer(config)
        f = zarr.open(container, "r")
        out[shards] = (np.asarray(f["embeddings"][:]), np.asarray(f["segmentation"][:]))
    np.testing.assert_allclose(out[2][0], out[0][0], atol=1e-5, rtol=0)
    assert out[0][1].max() > 1
    np.testing.assert_array_equal(out[2][1], out[0][1])


def test_spatial_shards_on_too_few_gpus_raise():
    """On CUDA, fewer visible GPUs than ``spatial_shards`` raises the JAX
    package's ValueError before anything runs (here: none are visible)."""
    from cellulus_tpu_torch.parallel.spatial import spatial_devices

    with pytest.raises(ValueError, match="spatial_shards=2 but only 0 devices are visible"):
        spatial_devices(2, "cuda:0")
    assert spatial_devices(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="only 1 devices are given"):
        spatial_devices(2, "cpu", ["cpu"])
