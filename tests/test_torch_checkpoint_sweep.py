"""The port's checkpoint sweep (``cellulus_tpu_torch.infer.checkpoint_sweep``)
on the CPU: the JAX package's behaviour (tests/test_pipeline.py::
test_checkpoint_sweep), error rows, the tie-break, and the scores of both
packages' sweeps over the same checkpoints."""

import json
import shutil

import numpy as np
import pytest

import cellulus_tpu
from cellulus_tpu.configs import ExperimentConfig as JaxExperimentConfig
from cellulus_tpu.infer import checkpoint_sweep as jax_checkpoint_sweep
from cellulus_tpu.io import zarr
from cellulus_tpu.models.torch_export import save_torch_checkpoint
from cellulus_tpu.utils.checkpoint import load_checkpoint as load_jax_checkpoint
from cellulus_tpu_torch.configs import ExperimentConfig
from cellulus_tpu_torch.infer import checkpoint_sweep
from tests.unet_pairs import unet_pair

MODEL = {"num_fmaps": 8, "fmap_inc_factor": 2, "features_in_last_layer": 16}


def _experiment(container, out, checkpoint=None, device="cpu", pipelined=True):
    """tests/test_torch_infer.py's inference settings (no noise, threshold
    1.0) with an evaluation config; the train settings are the JAX test's."""
    def ds(name, secondary=None):
        d = {"container_path": str(out), "dataset_name": name}
        if secondary:
            d["secondary_dataset_name"] = secondary
        return d

    ic = {
        "crop_size": [68, 68],
        "num_infer_iterations": 1,
        "p_salt_pepper": 0.0,
        "threshold": 1.0,
        "pipelined": pipelined,
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
        "model_config": dict(MODEL, checkpoint=str(checkpoint) if checkpoint else None),
        "train_config": {
            "batch_size": 2, "crop_size": [36, 36], "kappa": 6.0, "max_iterations": 1,
            "num_workers": 1, "elastic_deform": False, "save_model_every": 1,
            "save_snapshot_every": 1000,
            "train_data_config": {"container_path": str(container), "dataset_name": "train"},
        },
        "inference_config": ic,
    }


def _stage_groundtruth(container, out):
    src = zarr.open(container, "r")["groundtruth"]
    f = zarr.open(out, "a")
    f["groundtruth"] = np.asarray(src[...])
    f["groundtruth"].attrs.update(src.attrs.asdict())


def _write_weights(models, names):
    models.mkdir(exist_ok=True)
    params = unet_pair(2, [(2, 2)])[1]
    for name in names:
        save_torch_checkpoint(models / name, params)


@pytest.fixture
def sweep_dir(blob_container_2d, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # evaluate writes its results files here
    out = tmp_path / "out.zarr"
    _stage_groundtruth(blob_container_2d, out)
    config = ExperimentConfig(**_experiment(blob_container_2d, out))
    return tmp_path, config


def test_checkpoint_sweep(sweep_dir):
    """Every checkpoint scored; identical weights give identical rows; the
    JSON names the winner, the first maximum in candidate order (numbered
    in ascending order, then best_loss); no sweep container is left."""
    tmp_path, config = sweep_dir
    models = tmp_path / "models"
    _write_weights(models, ["000002.pth", "000010.pth", "best_loss.pth"])
    rows = checkpoint_sweep(config, checkpoint_dir=models)
    assert list(rows) == ["000002.pth", "000010.pth", "best_loss.pth"]
    for row in rows.values():
        assert 0.0 <= row["F1"] <= 1.0 and 0.0 <= row["SEG"] <= 1.0
        assert row["F1"] == round(row["F1"], 4)
    assert rows["000002.pth"] == dict(rows["000010.pth"], checkpoint=str(models / "000002.pth"))
    report = json.loads((models / "checkpoint_sweep.json").read_text())
    assert report["selected"] == "000002.pth"
    assert report["rows"] == json.loads(json.dumps(rows))
    assert not list(tmp_path.glob("*.sweep-*"))


def test_tie_break_is_the_first_maximum_in_candidate_order(sweep_dir, monkeypatch):
    """With equal F1 everywhere the winner is the first candidate, whatever
    the names hash to; a later strictly better one wins, with the NOTE."""
    import cellulus_tpu_torch.infer as infer_mod

    tmp_path, config = sweep_dir
    models = tmp_path / "models"
    _write_weights(models, ["000005.pth", "000001.pth", "best_loss.pth"])
    f1 = {"000001": 0.5, "000005": 0.5, "best_loss": 0.5}

    def scored(cfg, *args, **kwargs):
        stem = cfg.model_config.checkpoint.rsplit("/", 1)[-1].removesuffix(".pth")
        return {0: {"F1": f1[stem], "SEG": 0.25}}

    monkeypatch.setattr(infer_mod, "infer", scored)
    checkpoint_sweep(config, checkpoint_dir=models)
    assert json.loads((models / "checkpoint_sweep.json").read_text())["selected"] == "000001.pth"
    f1["000005"] = 0.75
    checkpoint_sweep(config, checkpoint_dir=models)
    assert json.loads((models / "checkpoint_sweep.json").read_text())["selected"] == "000005.pth"


def test_truncated_checkpoint_gives_an_error_row(sweep_dir, capsys):
    tmp_path, config = sweep_dir
    models = tmp_path / "models"
    _write_weights(models, ["000000.pth", "best_loss.pth"])
    data = (models / "000000.pth").read_bytes()
    (models / "000001.pth").write_bytes(data[: len(data) // 2])
    rows = checkpoint_sweep(config, checkpoint_dir=models, keep_outputs=True)
    assert "error" in rows["000001.pth"] and "F1" not in rows["000001.pth"]
    assert "F1" in rows["000000.pth"] and "F1" in rows["best_loss.pth"]
    assert "000001.pth: FAILED" in capsys.readouterr().out
    # --keep-sweep-outputs keeps every scored container
    kept = sorted(p.name for p in tmp_path.glob("*.sweep-*"))
    assert kept == ["out.zarr.sweep-000000", "out.zarr.sweep-000001", "out.zarr.sweep-best_loss"]
    assert "segmentation" in zarr.open(tmp_path / "out.zarr.sweep-best_loss", "r")


def test_every_checkpoint_failing_raises(sweep_dir):
    tmp_path, config = sweep_dir
    models = tmp_path / "models"
    models.mkdir()
    (models / "000000.pth").write_bytes(b"not a checkpoint")
    (models / "best_loss.pth").write_bytes(b"")
    with pytest.raises(RuntimeError, match="every checkpoint"):
        checkpoint_sweep(config, checkpoint_dir=models)
    with pytest.raises(ValueError, match="no .pth checkpoints"):
        checkpoint_sweep(config, checkpoint_dir=tmp_path / "empty")


def test_sweep_needs_ground_truth(sweep_dir):
    tmp_path, config = sweep_dir
    config.inference_config.evaluation_dataset_config = None
    with pytest.raises(ValueError, match="evaluation_dataset_config"):
        checkpoint_sweep(config, checkpoint_dir=tmp_path)


def test_sweep_matches_the_jax_package(blob_container_2d, tmp_path, monkeypatch):
    """The JAX package trains one iteration (000000.ckpt, best_loss.ckpt);
    each checkpoint is written as .pth and both packages sweep the same
    weights, pipelined. tests/test_torch_infer.py's rule (embeddings within
    3e-4; a fit seed may part at a ball's boundary) lets one instance go
    either way: per checkpoint F1 agrees within 2 / (the fixture's ground
    truth instances) and SEG within 1e-2, and the bandwidth index is the
    same."""
    monkeypatch.chdir(tmp_path)
    jax_dir, torch_dir = tmp_path / "jax", tmp_path / "torch"
    jax_config = JaxExperimentConfig(**_experiment(blob_container_2d, jax_dir / "out.zarr",
                                                   device=None))
    jax_dir.mkdir()
    monkeypatch.chdir(jax_dir)
    cellulus_tpu.train(jax_config)
    models = jax_dir / "models"
    ckpts = sorted(p.name for p in models.glob("*.ckpt"))
    assert "best_loss.ckpt" in ckpts and "000000.ckpt" in ckpts
    (torch_dir / "models").mkdir(parents=True)
    for name in ckpts:
        save_torch_checkpoint(torch_dir / "models" / name.replace(".ckpt", ".pth"),
                              load_jax_checkpoint(models / name)["params"])

    _stage_groundtruth(blob_container_2d, jax_dir / "out.zarr")
    theirs = jax_checkpoint_sweep(jax_config, checkpoint_dir=models)
    monkeypatch.chdir(torch_dir)
    _stage_groundtruth(blob_container_2d, torch_dir / "out.zarr")
    mine = checkpoint_sweep(ExperimentConfig(**_experiment(blob_container_2d,
                                                           torch_dir / "out.zarr")),
                            checkpoint_dir=torch_dir / "models")
    gt = np.asarray(zarr.open(blob_container_2d, "r")["groundtruth"][...])
    n_gt = sum(len(np.unique(gt[s])) - 1 for s in range(len(gt)))
    assert sorted(mine) == sorted(n.replace(".ckpt", ".pth") for n in theirs)
    for name, ref in theirs.items():
        row = mine[name.replace(".ckpt", ".pth")]
        assert row["bandwidth_index"] == ref["bandwidth_index"]
        assert abs(row["F1"] - ref["F1"]) <= 2 / n_gt, (name, row, ref)
        assert abs(row["SEG"] - ref["SEG"]) <= 1e-2, (name, row, ref)
    assert not list(jax_dir.glob("*.sweep-*")) and not list(torch_dir.glob("*.sweep-*"))
    shutil.rmtree(jax_dir / "models")
