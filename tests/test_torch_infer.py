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
    """The whole slice through each package, then the port's detect, segment
    and evaluate on the JAX package's embeddings (``"torch_stages"``), so
    that those stages compare on the same input."""
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
            ("torch_stages", cellulus_tpu_torch.infer, ExperimentConfig, "cpu"),
        ):
            out = work / f"{name}.zarr"
            f = zarr.open(out, "a")
            f["groundtruth"] = gt[...]
            f["groundtruth"].attrs.update(gt.attrs.asdict())
            config = cfg_cls(**_config(blob_container_2d, out, checkpoint, device))
            if name == "torch_stages":
                embeddings = outs["jax"][0]["embeddings"]
                f["embeddings"] = embeddings[...]
                f["embeddings"].attrs.update(embeddings.attrs.asdict())
                config.inference_config.prediction_dataset_config = None
            results = run(config)
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
    """The port's detect and segment on the JAX package's embeddings give
    its partition exactly."""
    ref = both_runs["jax"][0][dataset][...]
    mine = both_runs["torch_stages"][0][dataset][...]
    assert mine.shape == ref.shape == (2, 1, 128, 128)
    for s in range(2):
        assert len(np.unique(mine[s])) > 10  # a real clustering, not an empty mask
        assert _same_partition(mine[s], ref[s])


# a fit seed may part ways from the JAX package's at most this often a sample
MAX_PARTED_SEEDS = 3


def test_own_path_parts_ways_only_at_boundary_seeds(both_runs):
    """The port's own path, from its own embeddings (within 3e-4 of the
    JAX package's) to its own detections: the same foreground and instance
    count, and every pixel where the partitions disagree lies in an
    instance whose kept centre has no counterpart on the other side. Those
    come from at most MAX_PARTED_SEEDS fit seeds a sample, found by running
    both packages' fits on the port's fit input, and each of them meets a
    point within rounding of a ball's boundary on its trajectory
    (``near_boundary``): there two fits that sum in other orders may decide
    the ball test differently."""
    import jax.numpy as jnp
    import torch

    from cellulus_tpu.ops import mean_shift as jax_ms
    from cellulus_tpu_torch.detect import sample_rng
    from cellulus_tpu_torch.ops import mean_shift as ms
    from cellulus_tpu_torch.ops.ball_stats import ball_stats_plain, point_set
    from cellulus_tpu_torch.ops.mean_shift_fit import mean_shift_fit_plain, near_boundary
    from cellulus_tpu_torch.utils.parity import disagreeing

    run, ref = both_runs["torch"][0], both_runs["jax"][0]
    ic = ExperimentConfig(**_config("c", "o", "w")).inference_config
    bw = 5.0  # 0.5 x object_size
    for s in range(2):
        mine, theirs = run["detection"][s, 0], ref["detection"][s, 0]
        assert ((mine == 0) == (theirs == 0)).all()
        assert len(np.unique(mine)) == len(np.unique(theirs)) > 10

        # the port's fit input for this sample, as its detect prepares it
        emb = np.asarray(run["embeddings"][s])
        mask = emb[-1] < ic.threshold
        X = ms.add_coordinate_grid(emb[:2]).reshape(2, -1).T[mask.ravel()]
        X_fit = X[sample_rng(ic.seed, s).random(len(X)) < ic.reduction_probability]
        seeds = ms.bin_seeds(X_fit, bw)
        bw2, stop = ms.fit_thresholds(bw)
        points = point_set(torch.from_numpy(X_fit), torch.ones(len(X_fit), dtype=torch.bool))
        trajectory = []

        def recorded(centers, pts, b):
            trajectory.append(centers.clone())
            return ball_stats_plain(centers, pts, b)

        centers, n_final, _, _ = mean_shift_fit_plain(
            torch.from_numpy(seeds), points, bw2, stop, ic.mean_shift_max_iterations, recorded)
        kept = ms._dedupe(centers, n_final, bw2).numpy()

        n_pad = jax_ms._next_pow2(max(len(X_fit), 256))
        s_pad = jax_ms._next_pow2(max(len(seeds), 64))
        chunk = max(256, min(1 << 18, (1 << 26) // s_pad, n_pad))
        sc, unique = jax_ms._fit_kernel(
            jnp.asarray(jax_ms._pad_rows(X_fit, n_pad)),
            jnp.asarray(jax_ms._pad_rows(np.ones(len(X_fit), bool), n_pad)),
            jnp.asarray(jax_ms._pad_rows(seeds, s_pad)),
            jnp.asarray(jax_ms._pad_rows(np.ones(len(seeds), bool), s_pad)),
            jnp.float32(bw), max_iter=ic.mean_shift_max_iterations, chunk=chunk)
        sc, unique = np.asarray(sc), np.asarray(unique)
        kept_ref = sc[unique]

        # seeds whose end has no counterpart among the JAX package's ends
        ends = centers.numpy()
        gap = np.sqrt(((ends[:, None] - sc[None]) ** 2).sum(-1)).min(1)
        parted = np.flatnonzero(gap > 1e-3)
        assert len(parted) <= MAX_PARTED_SEEDS
        for i in parted:
            assert any(bool(near_boundary(c[i : i + 1], points, bw2)[0]) for c in trajectory)

        between = np.sqrt(((kept[:, None] - kept_ref[None]) ** 2).sum(-1))
        parted_mine = between.min(1) > 1e-3
        parted_theirs = between.min(0) > 1e-3
        bad = disagreeing(mine, theirs)[0].reshape(mine.shape)
        for y, x in zip(*np.nonzero(bad)):
            assert parted_mine[mine[y, x] - 1] or parted_theirs[theirs[y, x] - 1]


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
