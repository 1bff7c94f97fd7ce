"""Multi-channel raw data and several training datasets through the port
and the JAX package (``tests/test_multichannel.py`` and
``tests/test_multi_dataset.py``'s inputs).

Each case trains both packages three steps from one ``.pth`` (their
``loss.csv`` rows agree at tests/test_torch_train.py's rtol 1e-5); then the
port infers from the ``best_loss.ckpt`` the JAX package wrote, read by its
msgpack reader, and its embeddings equal the JAX package's infer within
tests/test_torch_infer.py's 3e-4. The port's detect and segment on the JAX
package's embeddings give its partition up to ids, or differ only where
rounding explains it (``utils/parity.unexplained_mean_shift``: a fit seed
parted at a ball's boundary, or predict rounding)."""

import csv
import os

import numpy as np
import pytest
import torch

import cellulus_tpu
import cellulus_tpu_torch
from cellulus_tpu.configs import ExperimentConfig as JaxExperimentConfig
from cellulus_tpu.io import zarr
from cellulus_tpu.models.torch_export import save_torch_checkpoint
from cellulus_tpu.models.torch_import import torch_state_dict_to_params
from cellulus_tpu_torch.configs import ExperimentConfig
from cellulus_tpu_torch.detect import sample_rng
from cellulus_tpu_torch.models import UNet, init_unet_
from cellulus_tpu_torch.ops import mean_shift as ms
from cellulus_tpu_torch.utils.parity import unexplained_mean_shift
from tests import detect_parity

CROP = 36
INFER_CROP = 52


@pytest.fixture(scope="module")
def multichannel_container(tmp_path_factory):
    """tests/test_multichannel.py's data: (2, 3, 96, 96) uint8."""
    path = tmp_path_factory.mktemp("mc") / "mc.zarr"
    raw = (np.random.default_rng(0).random((2, 3, 96, 96)) * 255).astype(np.uint8)
    f = zarr.open(path, "a")
    f["train"] = raw
    f["train"].attrs["axis_names"] = ["s", "c", "y", "x"]
    return path


def _experiment(container, out, train_data, checkpoint, normalization_factor, device=None):
    def ds(name, secondary=None):
        d = {"container_path": str(out), "dataset_name": name}
        if secondary:
            d["secondary_dataset_name"] = secondary
        return d

    train = {"batch_size": 2, "crop_size": [CROP, CROP], "kappa": 6.0, "max_iterations": 3,
             "num_workers": 1, "elastic_deform": False, "device_pair_sampling": False,
             "save_model_every": 2, "save_best_model_every": 2, "save_snapshot_every": 100,
             **train_data}
    infer = {"crop_size": [INFER_CROP, INFER_CROP], "num_infer_iterations": 1,
             # no noise, so both packages' embeddings compare; the threshold
             # above the zero uncertainty channel makes every pixel foreground
             "p_salt_pepper": 0.0, "threshold": 1.0,
             "dataset_config": {"container_path": str(container), "dataset_name": "train"},
             "prediction_dataset_config": ds("embeddings"),
             "detection_dataset_config": ds("detection", "embeddings"),
             "segmentation_dataset_config": ds("segmentation", "detection")}
    if device is not None:
        train["device"] = infer["device"] = device
    return {"object_size": 10, "normalization_factor": normalization_factor,
            "model_config": {"num_fmaps": 8, "fmap_inc_factor": 2, "features_in_last_layer": 16,
                             "checkpoint": str(checkpoint)},
            "train_config": train, "inference_config": infer}


def _csv_rows(path):
    with open(path) as f:
        return [[float(v) for v in row[1:3]] for row in list(csv.reader(f))[1:]]


def _run(work, container, train_data, in_channels, normalization_factor):
    """Both packages train from one .pth; the JAX package infers from its
    best_loss.ckpt, the port from the same file, and the port's detect and
    segment also run on the JAX package's embeddings."""
    start = work / "start.pth"
    model = UNet(in_channels, 2, 8, 2, 16, [[2, 2]], 2)
    init_unet_(model, "kaiming_normal", torch.Generator().manual_seed(0))
    save_torch_checkpoint(start, torch_state_dict_to_params(model.state_dict()),
                          iteration=-1, logger_data={"loss": [], "oce_loss": []})
    runs = {}
    cwd = os.getcwd()
    try:
        for name, cfg_cls, train, device in (
            ("jax", JaxExperimentConfig, cellulus_tpu.train, None),
            ("torch", ExperimentConfig, cellulus_tpu_torch.train, "cpu"),
        ):
            (work / name).mkdir()
            os.chdir(work / name)
            train(cfg_cls(**_experiment(container, work / name / "out.zarr", train_data, start,
                                        normalization_factor, device)))
        best = work / "jax" / "models" / "best_loss.ckpt"
        for name, cfg_cls, infer, device in (
            ("jax", JaxExperimentConfig, cellulus_tpu.infer, None),
            ("torch", ExperimentConfig, cellulus_tpu_torch.infer, "cpu"),
            ("torch_stages", ExperimentConfig, cellulus_tpu_torch.infer, "cpu"),
        ):
            out = work / f"{name}.zarr"
            config = cfg_cls(**_experiment(container, out, train_data, best,
                                           normalization_factor, device))
            if name == "torch":  # its embeddings; its detect runs as torch_stages
                config.inference_config.detection_dataset_config = None
                config.inference_config.segmentation_dataset_config = None
            if name == "torch_stages":
                embeddings = zarr.open(work / "jax.zarr", "r")["embeddings"]
                f = zarr.open(out, "a")
                f["embeddings"] = embeddings[...]
                f["embeddings"].attrs.update(embeddings.attrs.asdict())
                config.inference_config.prediction_dataset_config = None
            infer(config)
            runs[name] = zarr.open(out, "r")
    finally:
        os.chdir(cwd)
    runs["loss"] = {name: _csv_rows(work / name / "loss.csv") for name in ("jax", "torch")}
    return runs


@pytest.fixture(scope="module")
def cases(multichannel_container, blob_container_2d, tmp_path_factory):
    # one intra-op thread: the port's runs are tiny, and test workers run
    # side by side
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _cases(multichannel_container, blob_container_2d, tmp_path_factory)
    finally:
        torch.set_num_threads(before)


def _cases(multichannel_container, blob_container_2d, tmp_path_factory):
    mc = tmp_path_factory.mktemp("multichannel")
    md = tmp_path_factory.mktemp("multi_dataset")
    both = [{"container_path": str(blob_container_2d), "dataset_name": name}
            for name in ("train", "validate")]
    return {
        "multichannel": _run(mc, multichannel_container, {"train_data_config": {
            "container_path": str(multichannel_container), "dataset_name": "train"}}, 3,
            1.0 / 255),
        "multi_dataset": _run(md, blob_container_2d, {"train_data_configs": both}, 1, None),
    }


CASES = ["multichannel", "multi_dataset"]


@pytest.mark.parametrize("case", CASES)
def test_loss_csv_matches_jax(cases, case):
    want, got = cases[case]["loss"]["jax"], cases[case]["loss"]["torch"]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_embeddings_from_the_jax_ckpt_match(cases, case):
    ref, mine = cases[case]["jax"]["embeddings"], cases[case]["torch"]["embeddings"]
    assert mine.shape == ref.shape and mine.shape[1] == 3
    np.testing.assert_allclose(mine[...], ref[...], atol=3e-4)


@pytest.mark.parametrize("case", CASES)
def test_partition_matches_up_to_rounding(cases, case):
    ref, mine = cases[case]["jax"], cases[case]["torch_stages"]
    ic = ExperimentConfig(**_experiment("c", "o", {"train_data_config": {
        "container_path": "c", "dataset_name": "train"}}, "w", None)).inference_config
    ic.bandwidth = 5.0  # 0.5 x object_size
    bw2 = float(np.float32(ic.bandwidth) ** 2)
    for s in range(ref["detection"].shape[0]):
        theirs, got = ref["detection"][s, 0], mine["detection"][s, 0]
        assert len(np.unique(got)) > 3
        if _same_partition(got, theirs):
            assert _same_partition(mine["segmentation"][s, 0], ref["segmentation"][s, 0])
            continue
        emb = np.asarray(ref["embeddings"][s])
        mask = emb[-1] < ic.threshold
        X = ms.add_coordinate_grid(emb[:2]).reshape(2, -1).T[mask.ravel()]
        X_fit = ms.fit_subsample(X, ic.reduction_probability, sample_rng(ic.seed, s))
        seeds = ms.bin_seeds(X_fit, ic.bandwidth)
        bad, p_mine, p_theirs = unexplained_mean_shift(
            got, theirs, mask, X,
            detect_parity.kept_centres_port(X_fit, seeds, ic.bandwidth),
            detect_parity.kept_centres_jax(X_fit, seeds, ic.bandwidth), bw2)
        assert bad == [] and p_mine <= 3 and p_theirs <= 3, (s, bad, p_mine, p_theirs)


def _same_partition(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    if not ((a == 0) == (b == 0)).all():
        return False
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))
