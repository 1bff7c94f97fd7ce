"""Pipelined inference of the port (``cellulus_tpu_torch/pipeline.py``) on
the CPU: bit for bit the port's staged path in 2D cell mode, 2D nucleus
mode (host and device partition), greedy clustering and 3D; the host-RAM
gate; the staged fallback; and the port's pipelined output against the JAX
package's pipelined output under ``tests/test_torch_infer.py``'s rule.

Weights are the JAX package's params written as ``.pth``
(``save_torch_checkpoint``), no training."""

import os
import warnings

import jax
import numpy as np
import pytest

import cellulus_tpu
import cellulus_tpu_torch
from cellulus_tpu.configs import ExperimentConfig as JaxExperimentConfig
from cellulus_tpu.io import zarr
from cellulus_tpu.models import UNetSpec, init_params
from cellulus_tpu.models.torch_export import save_torch_checkpoint
from cellulus_tpu_torch import pipeline
from cellulus_tpu_torch.configs import ExperimentConfig
from cellulus_tpu_torch.infer import PIPELINED_STAGE
from tests.unet_pairs import unet_pair

DATASETS = ("embeddings", "detection", "binary-segmentation", "centered-embeddings",
            "segmentation")
MODEL = {"num_fmaps": 8, "fmap_inc_factor": 2, "features_in_last_layer": 16}


def _config(container, out, checkpoint, pipelined, ndim=2, device="cpu", **inference):
    def ds(name, secondary=None):
        d = {"container_path": str(out), "dataset_name": name}
        if secondary:
            d["secondary_dataset_name"] = secondary
        return d

    model = dict(MODEL, checkpoint=str(checkpoint))
    ic = {
        "crop_size": [68, 68],
        "num_infer_iterations": 2,
        "pipelined": pipelined,
        "dataset_config": {"container_path": str(container), "dataset_name": "train"},
        "prediction_dataset_config": ds("embeddings"),
        "detection_dataset_config": ds("detection", "embeddings"),
        "segmentation_dataset_config": ds("segmentation", "detection"),
        **inference,
    }
    if ndim == 3:
        model["downsampling_factors"] = [[1, 2, 2]]
        ic["crop_size"] = [28, 44, 44]
    if device is not None:
        ic["device"] = device
    return {"object_size": 10 if ndim == 2 else 12, "model_config": model,
            "inference_config": ic}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Seeded weights as the JAX package's params, written as ``.pth``, 2D
    and 3D."""
    work = tmp_path_factory.mktemp("pipeline_weights")
    save_torch_checkpoint(work / "w2.pth", unet_pair(2, [(2, 2)])[1])
    save_torch_checkpoint(work / "w3.pth", unet_pair(3, [(1, 2, 2)])[1])
    return {2: work / "w2.pth", 3: work / "w3.pth"}


def _run(container, out, checkpoint, pipelined, ndim=2, stage_seconds=None, **inference):
    config = ExperimentConfig(**_config(container, out, checkpoint, pipelined, ndim,
                                        **inference))
    cellulus_tpu_torch.infer(config, stage_seconds)
    return zarr.open(out, "r")


def _assert_same(a, b, names=DATASETS):
    for name in names:
        np.testing.assert_array_equal(a[name][...], b[name][...], err_msg=name)
        assert a[name].attrs.asdict() == b[name].attrs.asdict(), name


CASES = {
    "cell": (2, {}),
    "nucleus": (2, {"post_processing": "nucleus", "device_nucleus": False}),
    "nucleus-device": (2, {"post_processing": "nucleus", "device_nucleus": True}),
    "greedy": (2, {"clustering": "greedy"}),
    "3d": (3, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipelined_matches_staged(case, blob_container_2d, blob_container_3d, checkpoints,
                                  tmp_path, capsys):
    """Salt-and-pepper noise on (per-sample generators), Otsu threshold: the
    five datasets and their attributes equal the staged path's bit for bit,
    and the pipelined stage's timer line is printed."""
    ndim, inference = CASES[case]
    container = blob_container_2d if ndim == 2 else blob_container_3d
    seconds = {}
    staged = _run(container, tmp_path / "a.zarr", checkpoints[ndim], False, ndim, **inference)
    piped = _run(container, tmp_path / "b.zarr", checkpoints[ndim], True, ndim, seconds,
                 **inference)
    _assert_same(staged, piped)
    assert sorted(seconds) == [PIPELINED_STAGE]
    assert f"[perf] {PIPELINED_STAGE}: " in capsys.readouterr().out
    assert len(np.unique(piped["segmentation"][...])) > 2


def test_ram_gate_caps_workers_and_still_matches(blob_container_2d, checkpoints, tmp_path,
                                                 monkeypatch):
    """A tiny budget from the env var caps the stage workers with a warning
    and the outputs still match; ``pipeline_ram_gb`` in the config wins over
    a generous env value."""
    staged = _run(blob_container_2d, tmp_path / "a.zarr", checkpoints[2], False)
    # a 128^2 sample holds ~0.2 MB in flight: 0.0005 GB leaves one worker
    monkeypatch.setenv("CELLULUS_TPU_PIPELINE_RAM_GB", "0.0005")
    for out, inference in (("b.zarr", {}), ("c.zarr", {"pipeline_ram_gb": 0.0005})):
        if inference:
            monkeypatch.setenv("CELLULUS_TPU_PIPELINE_RAM_GB", "64")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            piped = _run(blob_container_2d, tmp_path / out, checkpoints[2], True, **inference)
        assert any("capping stage workers 2 -> 1" in str(w.message) for w in caught), out
        _assert_same(staged, piped)


def test_generous_budget_keeps_the_workers(blob_container_2d, checkpoints, tmp_path,
                                           monkeypatch):
    monkeypatch.setenv("CELLULUS_TPU_PIPELINE_RAM_GB", "64")
    ic = ExperimentConfig(**_config(blob_container_2d, tmp_path / "o.zarr", checkpoints[2],
                                    True)).inference_config
    from cellulus_tpu_torch.io import DatasetMetaData

    meta = DatasetMetaData.from_dataset_config(ic.dataset_config)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert pipeline.stage_workers_for(ic, meta, 2) == 2


def test_missing_stage_config_takes_the_staged_path(blob_container_2d, checkpoints, tmp_path):
    """``pipelined = true`` with no segmentation config runs predict and
    detect staged, as the JAX package does."""
    seconds = {}
    config = ExperimentConfig(**_config(blob_container_2d, tmp_path / "o.zarr",
                                        checkpoints[2], True))
    config.inference_config.segmentation_dataset_config = None
    cellulus_tpu_torch.infer(config, seconds)
    assert sorted(seconds) == ["detect", "predict"]
    assert "segmentation" not in os.listdir(tmp_path / "o.zarr")


def test_worker_failure_fails_the_run(blob_container_2d, checkpoints, tmp_path, monkeypatch):
    """A stage worker's error reaches the caller; no staged rerun."""
    def broken(*args, **kwargs):
        raise RuntimeError("segment failed in a worker")

    monkeypatch.setattr(pipeline, "segment_sample", broken)
    config = ExperimentConfig(**_config(blob_container_2d, tmp_path / "o.zarr",
                                        checkpoints[2], True))
    with pytest.raises(RuntimeError, match="segment failed in a worker"):
        cellulus_tpu_torch.infer(config)


def test_intervals_cover_every_sample(blob_container_2d, checkpoints, tmp_path):
    """Each sample's predict (calling thread), detect and segment (worker)
    intervals on one host clock: a sample's detect starts after its
    predict ends, and its segment after its detect."""
    intervals = {}
    config = ExperimentConfig(**_config(blob_container_2d, tmp_path / "o.zarr",
                                        checkpoints[2], True))
    cellulus_tpu_torch.infer(config, None, intervals)
    assert sorted(intervals) == ["detect", "predict", "segment"]
    for s in range(2):
        p, d, g = (intervals[k][s] for k in ("predict", "detect", "segment"))
        assert p[0] <= p[1] <= d[0] <= d[1] <= g[0] <= g[1]


def test_pipelined_port_holds_to_the_jax_pipelined_path(blob_container_2d, tmp_path,
                                                        monkeypatch):
    """tests/test_torch_infer.py's rule for the port's staged path, applied
    to the pipelined paths of both packages on the same weights (its
    settings: no noise, threshold 1.0): embeddings within 3e-4, the same
    foreground and instance count a sample, and F1 and SEG equal."""
    monkeypatch.chdir(tmp_path)  # evaluate writes its results files here
    # tests/test_torch_infer.py's weights: its rule is stated for them
    weights = tmp_path / "w.pth"
    save_torch_checkpoint(weights, init_params(jax.random.PRNGKey(0),
                                               UNetSpec(1, 2, 8, 2, 16, ((2, 2),), 2)))
    gt = zarr.open(blob_container_2d, "r")["groundtruth"]
    results, outs = {}, {}
    for name, run, cfg_cls, device in (("jax", cellulus_tpu.infer, JaxExperimentConfig, None),
                                       ("torch", cellulus_tpu_torch.infer, ExperimentConfig,
                                        "cpu")):
        out = tmp_path / f"{name}.zarr"
        f = zarr.open(out, "a")
        f["groundtruth"] = gt[...]
        f["groundtruth"].attrs.update(gt.attrs.asdict())
        raw = _config(blob_container_2d, out, weights, True, device=device,
                      num_infer_iterations=1, p_salt_pepper=0.0, threshold=1.0,
                      evaluation_dataset_config={"container_path": str(out),
                                                 "dataset_name": "groundtruth",
                                                 "secondary_dataset_name": "segmentation"})
        results[name] = run(cfg_cls(**raw))
        outs[name] = zarr.open(out, "r")
    np.testing.assert_allclose(outs["torch"]["embeddings"][...],
                               outs["jax"]["embeddings"][...], atol=3e-4)
    for s in range(2):
        mine, ref = outs["torch"]["detection"][s, 0], outs["jax"]["detection"][s, 0]
        assert ((mine == 0) == (ref == 0)).all()
        assert len(np.unique(mine)) == len(np.unique(ref)) > 10
    assert results["torch"] == results["jax"]
