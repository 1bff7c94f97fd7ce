"""The whole slice, predict -> detect -> segment -> evaluate, through the
port (CPU) and the JAX package on the same weights and data."""

import os
from pathlib import Path

import jax
import numpy as np
import pytest

import cellulus_tpu
import cellulus_tpu_torch
from cellulus_tpu.configs import ExperimentConfig as JaxExperimentConfig
from cellulus_tpu.io import zarr
from cellulus_tpu.models import UNetSpec, init_params
from cellulus_tpu.models.torch_export import save_torch_checkpoint
from cellulus_tpu.segment import cell_segment_sample as jax_cell_segment_sample
from cellulus_tpu_torch.configs import ExperimentConfig
from cellulus_tpu_torch.segment import cell_segment_sample


def _config(container, out, checkpoint, device=None):
    def ds(name, secondary=None):
        d = {"container_path": str(out), "dataset_name": name}
        if secondary:
            d["secondary_dataset_name"] = secondary
        return d

    ic = {
        "crop_size": [68, 68],
        "num_infer_iterations": 1,
        "p_salt_pepper": 0.0,
        # without noise the uncertainty channel is 0: a fixed threshold
        # above it makes every pixel foreground, so the mean shift clusters
        # the whole image
        "threshold": 1.0,
        "dataset_config": {"container_path": str(container), "dataset_name": "train"},
        "prediction_dataset_config": ds("embeddings"),
        "detection_dataset_config": ds("detection", "embeddings"),
        "segmentation_dataset_config": ds("segmentation", "detection"),
        "evaluation_dataset_config": ds("groundtruth", "segmentation"),
    }
    if device is not None:
        ic["device"] = device
    return {
        "object_size": 10,
        "model_config": {
            "num_fmaps": 8, "fmap_inc_factor": 2, "features_in_last_layer": 16,
            "checkpoint": str(checkpoint),
        },
        "inference_config": ic,
    }


@pytest.fixture(scope="module")
def both_runs(blob_container_2d, tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_infer")
    spec = UNetSpec(1, 2, 8, 2, 16, ((2, 2),), 2)
    checkpoint = work / "weights.pth"
    save_torch_checkpoint(checkpoint, init_params(jax.random.PRNGKey(0), spec))
    gt = zarr.open(blob_container_2d, "r")["groundtruth"]
    outs = {}
    cwd = os.getcwd()
    os.chdir(work)  # evaluate writes its results files to the working directory
    try:
        for name, run, cfg_cls, device in (
            ("jax", cellulus_tpu.infer, JaxExperimentConfig, None),
            ("torch", cellulus_tpu_torch.infer, ExperimentConfig, "cpu"),
        ):
            out = work / f"{name}.zarr"
            f = zarr.open(out, "a")
            f["groundtruth"] = gt[...]
            f["groundtruth"].attrs.update(gt.attrs.asdict())
            results = run(cfg_cls(**_config(blob_container_2d, out, checkpoint, device)))
            outs[name] = (zarr.open(out, "r"), results)
    finally:
        os.chdir(cwd)
    return outs


def _same_partition(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    if not ((a == 0) == (b == 0)).all():
        return False
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def test_embeddings_match(both_runs):
    ref, mine = both_runs["jax"][0]["embeddings"], both_runs["torch"][0]["embeddings"]
    assert mine.shape == ref.shape == (2, 3, 128, 128)
    assert mine.attrs["axis_names"] == ["s", "c", "y", "x"]
    np.testing.assert_allclose(mine[...], ref[...], atol=3e-4)


@pytest.mark.parametrize("dataset", ["detection", "segmentation"])
def test_instances_match_up_to_ids(both_runs, dataset):
    ref = both_runs["jax"][0][dataset][...]
    mine = both_runs["torch"][0][dataset][...]
    assert mine.shape == ref.shape == (2, 1, 128, 128)
    for s in range(2):
        assert len(np.unique(mine[s])) > 10  # a real clustering, not an empty mask
        assert _same_partition(mine[s], ref[s])


def test_f1_and_seg_match(both_runs):
    assert both_runs["torch"][1] == both_runs["jax"][1]


@pytest.mark.parametrize("min_size", [0, 12])
def test_cell_segment_sample_bit_equal(both_runs, min_size):
    detections = both_runs["jax"][0]["detection"][0, 0]
    mine = cell_segment_sample(detections, 3, 6, min_size, "cpu")
    ref = jax_cell_segment_sample(detections, 3, 6, min_size)
    assert mine.dtype == ref.dtype
    np.testing.assert_array_equal(mine, ref)


def test_configs_parse_the_same_toml():
    path = Path(__file__).resolve().parents[1] / "examples" / "2d" / "infer.toml"
    mine = ExperimentConfig.from_toml(path)
    assert str(mine) == str(JaxExperimentConfig.from_toml(path))
    assert mine.model_config.num_fmaps == 64 and mine.inference_config.precision == "bfloat16"


def test_cuda_without_cuda_raises(blob_container_2d, tmp_path):
    """The default device is cuda:0; with no CUDA the port refuses to run."""
    cfg = ExperimentConfig(**_config(blob_container_2d, tmp_path / "o.zarr", tmp_path / "w.pth"))
    assert cfg.inference_config.device == "cuda:0"
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cellulus_tpu_torch.infer(cfg)
