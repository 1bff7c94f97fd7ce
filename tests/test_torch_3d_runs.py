"""The 3D path of the port (CPU) run end to end against the JAX package's,
on the same weights and volumes: the infer slice on ``blob_container_3d``
(predict -> detect -> segment -> evaluate), the 3D ``min_size``, ``train()``
in 3D, and the command line on the ``examples/3d`` TOMLs."""

import csv
import os

import numpy as np
import pytest

import cellulus_tpu
import cellulus_tpu_torch
from cellulus_tpu.configs import ExperimentConfig as JaxExperimentConfig
from cellulus_tpu.io import zarr
from cellulus_tpu.models.torch_export import save_torch_checkpoint
from cellulus_tpu_torch.configs import ExperimentConfig
from tests.unet_pairs import unet_pair


def _same_partition(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    if not ((a == 0) == (b == 0)).all():
        return False
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


# -- the infer slice ---------------------------------------------------------------

INFER_MODEL = {"num_fmaps": 8, "fmap_inc_factor": 2, "features_in_last_layer": 16,
               "downsampling_factors": [[1, 2, 2]]}


def _infer_config(container, out, checkpoint, device=None, object_size=12):
    def ds(name, secondary=None):
        d = {"container_path": str(out), "dataset_name": name}
        if secondary:
            d["secondary_dataset_name"] = secondary
        return d

    ic = {
        "crop_size": [28, 44, 44],
        "num_infer_iterations": 1,
        "p_salt_pepper": 0.0,
        # without noise the uncertainty channel is 0: every voxel is foreground
        "threshold": 1.0,
        "dataset_config": {"container_path": str(container), "dataset_name": "train"},
        "prediction_dataset_config": ds("embeddings"),
        "detection_dataset_config": ds("detection", "embeddings"),
        "segmentation_dataset_config": ds("segmentation", "detection"),
        "evaluation_dataset_config": ds("groundtruth", "segmentation"),
    }
    if device is not None:
        ic["device"] = device
    return {"object_size": object_size,
            "model_config": {**INFER_MODEL, "checkpoint": str(checkpoint)},
            "inference_config": ic}


@pytest.fixture(scope="module")
def both_runs(blob_container_3d, tmp_path_factory):
    """The whole 3D slice through both packages, at examples/3d's
    object_size 12. Random weights leave the embeddings close to the voxel
    lattice, where a voxel within float rounding of a ball's boundary lets
    the two fits (which sum in other orders) part ways; this fixture has
    none, and the results agree exactly. At other object sizes a few of the
    110,592 voxels can go either way."""
    work = tmp_path_factory.mktemp("torch_infer_3d")
    _, params, _ = unet_pair(3, [(1, 2, 2)])
    checkpoint = work / "weights.pth"
    save_torch_checkpoint(checkpoint, params)
    gt = zarr.open(blob_container_3d, "r")["groundtruth"]
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
            config = cfg_cls(**_infer_config(blob_container_3d, out, checkpoint, device))
            results = run(config)
            outs[name] = (zarr.open(out, "r"), results, config.inference_config.min_size)
    finally:
        os.chdir(cwd)
    return outs


def test_3d_embeddings_match(both_runs):
    """Tiled 3D predict with reflect halos in three axes: atol 3e-4."""
    ref, mine = both_runs["jax"][0]["embeddings"], both_runs["torch"][0]["embeddings"]
    assert mine.shape == ref.shape == (1, 4, 48, 48, 48)
    assert mine.attrs["axis_names"] == ["s", "c", "z", "y", "x"]
    np.testing.assert_allclose(mine[...], ref[...], atol=3e-4)


@pytest.mark.parametrize("dataset", ["detection", "segmentation"])
def test_3d_instances_match_up_to_ids(both_runs, dataset):
    ref = both_runs["jax"][0][dataset][...]
    mine = both_runs["torch"][0][dataset][...]
    assert mine.shape == ref.shape == (1, 1, 48, 48, 48)
    assert len(np.unique(mine)) > 50  # a real clustering, not an empty mask
    assert _same_partition(mine, ref)


def test_3d_f1_seg_and_min_size_match(both_runs):
    assert both_runs["torch"][1] == both_runs["jax"][1]
    # a tenth of the volume of a ball of diameter object_size = 12
    assert both_runs["torch"][2] == both_runs["jax"][2] == int(0.1 * 4 / 3 * np.pi * 12**3 / 8)


@pytest.mark.parametrize("ndim", [2, 3])
def test_min_size_is_derived_before_the_weights_are_read(blob_container_2d, blob_container_3d,
                                                         tmp_path, ndim):
    """The formulas of ``cellulus_tpu/infer.py:42-50`` (the slice above
    checks the JAX package's own value in 3D)."""
    container = blob_container_3d if ndim == 3 else blob_container_2d
    config = ExperimentConfig(**_infer_config(container, tmp_path / "o.zarr",
                                              tmp_path / "none.pth", "cpu", object_size=13))
    if ndim == 2:
        config.model_config.downsampling_factors = [[2, 2]]
    with pytest.raises(FileNotFoundError):
        cellulus_tpu_torch.infer(config)
    want = int(0.1 * np.pi * 13**2 / 4) if ndim == 2 else int(0.1 * 4 / 3 * np.pi * 13**3 / 8)
    assert config.inference_config.min_size == want


# -- train ----------------------------------------------------------------------


def _train_dict(container, **overrides):
    train = {
        "batch_size": 2, "crop_size": [20, 36, 36], "kappa": 3.0, "density": 0.1,
        "pair_count_mode": "all_dims", "max_iterations": 3, "num_workers": 1,
        "elastic_deform": False, "device_pair_sampling": False, "save_model_every": 2,
        "save_best_model_every": 2, "save_snapshot_every": 2,
        "train_data_config": {"container_path": str(container), "dataset_name": "train"},
    }
    train.update(overrides)
    return {"object_size": 8, "model_config": dict(INFER_MODEL), "train_config": train}


def _csv_rows(path):
    with open(path) as f:
        return [[float(v) for v in row[1:3]] for row in list(csv.reader(f))[1:]]


def test_train_3d_runtime_matches_jax(blob_container_3d, tmp_path, monkeypatch):
    """JAX's train() and the port's on one tiny 3D config (all_dims pairs
    drawn on the host, one worker, elastic off, so both draw the same numpy
    stream), both starting from one .pth: loss.csv rows at rtol 1e-5, and a
    3D snapshot."""
    _, params, _ = unet_pair(3, [(1, 2, 2)])
    start = tmp_path / "start.pth"
    save_torch_checkpoint(start, params, iteration=-1, logger_data={"loss": [], "oce_loss": []})
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_config = JaxExperimentConfig(**_train_dict(blob_container_3d))
    jax_config.model_config.checkpoint = str(start)
    cellulus_tpu.train(jax_config)
    monkeypatch.chdir(tmp_path / "port")
    config = ExperimentConfig(**_train_dict(blob_container_3d, device="cpu"))
    config.model_config.checkpoint = str(start)
    state = cellulus_tpu_torch.train(config)

    want, got = _csv_rows(tmp_path / "jax" / "loss.csv"), _csv_rows(tmp_path / "port" / "loss.csv")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert state["iteration"] == 2
    assert sorted(os.listdir("models")) == ["000000.pth", "000002.pth", "best_loss.pth"]
    snapshot = zarr.open("snapshots.zarr", "r")
    assert snapshot["2/raw"].shape == (2, 1, 20, 36, 36)
    assert snapshot["2/prediction"].shape == (2, 3, 8, 20, 20)
    assert snapshot["2/prediction"].attrs["axis_names"] == ["s", "c", "z", "y", "x"]


def test_train_3d_with_elastic_and_device_pairs(blob_container_3d, tmp_path, monkeypatch):
    """The 3D host elastic warp and the 3D device pair sampler in one
    short run (the port alone: the pairs come from torch's stream)."""
    monkeypatch.chdir(tmp_path)
    config = ExperimentConfig(**_train_dict(blob_container_3d, device="cpu", max_iterations=2,
                                            elastic_deform=True, device_pair_sampling=True,
                                            control_point_spacing=8,
                                            control_point_jitter=1.0))
    state = cellulus_tpu_torch.train(config)
    assert state["iteration"] == 1 and np.isfinite(state["logger_data"]["loss"]).all()


# -- the command line ------------------------------------------------------------------


def _edit(text, *pairs):
    for old, new in pairs:
        assert old in text, old
        text = text.replace(old, new)
    return text


def test_cli_runs_the_examples_3d_tomls(blob_container_3d, tmp_path):
    """``python -m cellulus_tpu_torch train examples/3d/train.toml`` and
    ``infer`` on a copy of ``examples/3d/infer.toml`` (greedy clustering
    as it sets it) with a ``.pth`` checkpoint, on the CPU at a small crop,
    one step and one TTA iteration (the model as the TOMLs set it)."""
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    shutil.copytree(blob_container_3d, tmp_path / "data_3d.zarr")
    train = _edit((repo / "examples" / "3d" / "train.toml").read_text(),
                  ("crop_size = [40, 76, 76]", "crop_size = [28, 36, 36]"),
                  ("max_iterations = 5000", 'max_iterations = 1\ndevice = "cpu"'))
    infer = _edit((repo / "examples" / "3d" / "infer.toml").read_text(),
                  ('checkpoint = "models/best_loss.ckpt"', 'checkpoint = "models/000000.pth"'),
                  ("crop_size = [40, 76, 76]",
                   'crop_size = [28, 36, 36]\nnum_infer_iterations = 1\ndevice = "cpu"'))
    assert 'clustering = "greedy"' in infer
    (tmp_path / "train.toml").write_text(train)
    (tmp_path / "infer.toml").write_text(infer)
    gt = zarr.open(tmp_path / "data_3d.zarr", "r")["groundtruth"]
    out = zarr.open(tmp_path / "out_3d.zarr", "a")
    out["groundtruth"] = gt[...]
    out["groundtruth"].attrs.update(gt.attrs.asdict())
    env = dict(os.environ, PYTHONPATH=str(repo))
    for command in ("train", "infer"):
        proc = subprocess.run([sys.executable, "-m", "cellulus_tpu_torch", command,
                               f"{command}.toml"], cwd=tmp_path, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
    assert "F1 for dataset" in proc.stdout
    seg = zarr.open(tmp_path / "out_3d.zarr", "r")["segmentation"]
    assert seg.shape == (1, 1, 48, 48, 48) and seg[...].max() > 0
