"""Device lists (``parallel/mesh.py``) on the CPU, N times ``cpu``: predict's
tile batch split over them equals one device, as the JAX package's mesh
does (``tests/test_parallel.py:63-76``), and the stages' round-robin of
samples (detect, segment, the pipelined path) and the bandwidth sweep's
fits over them equal the serial run."""

import shutil

import numpy as np
import pytest
import torch

import cellulus_tpu_torch
import chip_smoke
from cellulus_tpu_torch.configs import InferenceConfig
from cellulus_tpu_torch.detect import detect
from cellulus_tpu_torch.io import zarr
from cellulus_tpu_torch.parallel import local_devices, shard_batch
from cellulus_tpu_torch.pipeline import infer_pipelined
from cellulus_tpu_torch.predict import predict_sample
from cellulus_tpu_torch.segment import segment
from tests.unet_pairs import unet_pair

MODEL = dict(num_fmaps=6, fmap_inc_factor=2, features_in_last_layer=8,
             downsampling_factors=[[2, 2]])
SETTINGS = dict(object_size=10, device="cpu", crop_size=[60, 60], num_infer_iterations=2,
                mean_shift_max_iterations=30)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the cases are small, and test workers run side
    by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_local_devices():
    assert local_devices(3, "cpu") == [torch.device("cpu")] * 3
    assert local_devices(device="cpu") == [torch.device("cpu")]
    # a CUDA request for more GPUs than are visible (none here) raises
    with pytest.raises(ValueError, match="requested 2 data shards but only 0 devices"):
        local_devices(2, "cuda:0")
    parts = shard_batch(torch.arange(5), ["cpu"] * 3)
    assert [p.tolist() for _, p in parts] == [[0, 1], [2, 3], [4]]
    # a batch shorter than the list leaves the last devices without a chunk
    assert [p.tolist() for _, p in shard_batch(torch.arange(2), ["cpu"] * 3)] == [[0], [1]]


@pytest.mark.parametrize("n_devices", [2, 3])
def test_tile_batch_split_equals_one_device(n_devices):
    """A batch of 8 tiles over 2 or 3 CPU devices (4 + 4; 3 + 3 + 2) gives
    one device's embeddings: the batch's draws are made once and split with
    it (atol 1e-5, as the JAX package's mesh test)."""
    _, _, model = unet_pair(2, [[2, 2]], seed=1)
    raw = np.random.default_rng(2).random((1, 100, 100)).astype(np.float32)
    ic = InferenceConfig(crop_size=[52, 52], num_infer_iterations=2, tile_batch_size=8,
                         device="cpu")
    one = predict_sample(model, raw, ic, 1.0, 0, "cpu")
    split = predict_sample(model, raw, ic, 1.0, 0, "cpu", devices=["cpu"] * n_devices)
    np.testing.assert_allclose(split, one, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def embeddings_container(tmp_path_factory):
    """Three samples through predict (random weights), the embeddings the
    stages read."""
    work = tmp_path_factory.mktemp("lists")
    chip_smoke.save_random_checkpoint(work / "w.pth", seed=4, **MODEL)
    container = chip_smoke.write_blob_container(work / "data.zarr", 3, 96, seed=5)
    config = chip_smoke.infer_config(container, work / "w.pth", MODEL, **SETTINGS)
    ic = config.inference_config
    ic.detection_dataset_config = ic.segmentation_dataset_config = None
    ic.evaluation_dataset_config = None
    cellulus_tpu_torch.infer(config)
    return work, container


def _copy(container, path):
    shutil.copytree(container, path)
    return path


@pytest.mark.parametrize("variant", ["meanshift", "sweep"])
def test_detect_and_segment_round_robin_equal_serial(embeddings_container, tmp_path, variant):
    """detect and segment over ``["cpu", "cpu"]`` (samples and jobs taking
    the devices in turn, a thread each; the sweep's 2 bandwidths one a
    device) write what the serial stages write."""
    work, container = embeddings_container
    extra = {"sweep": dict(num_bandwidths=2, vectorized_bandwidth_sweep=True)}.get(variant, {})
    out = {}
    for name, devices in (("serial", ["cpu"]), ("round-robin", ["cpu", "cpu"])):
        path = _copy(container, tmp_path / f"{name}.zarr")
        ic = chip_smoke.infer_config(path, work / "w.pth", MODEL, **SETTINGS, bandwidth=5.0,
                                     min_size=8, **extra).inference_config
        detect(ic, "cpu", devices=devices)
        segment(ic, "cpu", devices=devices)
        f = zarr.open(path, "r")
        out[name] = {n: np.asarray(f[n][:]) for n in ("detection", "binary-segmentation",
                                                       "centered-embeddings", "segmentation")}
    assert out["serial"]["segmentation"].max() > 1
    for n, want in out["serial"].items():
        np.testing.assert_array_equal(out["round-robin"][n], want, err_msg=n)


def test_pipelined_over_devices_equals_one_device(embeddings_container, tmp_path):
    """The pipelined path over ``["cpu", "cpu"]`` (tile batches split, each
    sample's detect and segment on its device) writes what it writes on one."""
    work, container = embeddings_container
    out = {}
    for name, devices in (("one", ["cpu"]), ("two", ["cpu", "cpu"])):
        path = _copy(container, tmp_path / f"{name}.zarr")
        config = chip_smoke.infer_config(path, work / "w.pth", MODEL, **SETTINGS, bandwidth=5.0,
                                         min_size=8)
        model = chip_smoke.random_unet(4, **MODEL)
        infer_pipelined(model.eval(), config.inference_config, None, "cpu", devices=devices)
        f = zarr.open(path, "r")
        out[name] = {n: np.asarray(f[n][:]) for n in ("embeddings", "detection", "segmentation")}
    np.testing.assert_allclose(out["two"]["embeddings"], out["one"]["embeddings"], atol=1e-5)
    for n in ("detection", "segmentation"):
        np.testing.assert_array_equal(out["two"][n], out["one"][n], err_msg=n)
