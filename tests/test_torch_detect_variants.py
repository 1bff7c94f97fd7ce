"""The detect variants through the port (CPU) and the JAX package on the
same inputs: greedy clustering, the seeds of seeded mean shift, seeded
mean shift, the bandwidth sweep, device detect, and a 2D infer slice per
variant (the port's detect and segment on the JAX package's embeddings)."""

import os
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import cellulus_tpu
import cellulus_tpu_torch
from cellulus_tpu.configs import ExperimentConfig as JaxExperimentConfig
from cellulus_tpu.configs import InferenceConfig as JaxInferenceConfig
from cellulus_tpu.detect import detect_sample as jax_detect_sample
from cellulus_tpu.io import zarr
from cellulus_tpu.models import UNetSpec, init_params
from cellulus_tpu.models.torch_export import save_torch_checkpoint
from cellulus_tpu.ops import peaks as jax_peaks
from cellulus_tpu.ops.greedy_cluster import greedy_cluster as jax_greedy_cluster
from cellulus_tpu.ops.mean_shift import (
    mean_shift_fit_predict as jax_fit_predict,
    mean_shift_sweep_fit_predict as jax_sweep,
)
from cellulus_tpu_torch.configs import ExperimentConfig, InferenceConfig
from cellulus_tpu_torch.detect import detect_sample
from cellulus_tpu_torch.ops import peaks
from cellulus_tpu_torch.ops.greedy_cluster import greedy_cluster
from cellulus_tpu_torch.ops.mean_shift import (
    mean_shift_fit_predict,
    mean_shift_sweep_fit_predict,
)
from cellulus_tpu_torch.ops.otsu import quantile_device, threshold_otsu_device


def _same_partition(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    if not ((a == 0) == (b == 0)).all():
        return False
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


# -- greedy clustering ------------------------------------------------------------------


def _greedy_parity_fixture(trial):
    """tests/test_greedy_parity.py's random fixtures (rng 7, three trials)."""
    rng = np.random.default_rng(7)
    for t in range(trial + 1):
        h = w = 24
        pred = np.zeros((3, h, w), np.float32)
        pred[2] = rng.uniform(0.5, 1.0, (h, w)).astype(np.float32)
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        fg = np.zeros((h, w), bool)
        for _ in range(3):
            cy, cx = rng.integers(4, h - 4, 2)
            r = rng.integers(2, 4)
            m = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
            pred[0][m] = cx - xx[m] + rng.normal(0, 0.2, m.sum())
            pred[1][m] = cy - yy[m] + rng.normal(0, 0.2, m.sum())
            pred[2][m] = rng.uniform(0.0, 0.05)
            fg |= m
    return pred, fg


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_greedy_matches_jax_on_random_fixtures(trial):
    pred, fg = _greedy_parity_fixture(trial)
    stats = {}
    mine = greedy_cluster(pred, fg, bandwidth=2.5, min_object_size=3, device="cpu", stats=stats)
    ref = jax_greedy_cluster(pred, fg, bandwidth=2.5, min_object_size=3)
    np.testing.assert_array_equal(mine, ref)
    assert stats["instances"] == len(np.unique(ref)) - 1 and stats["host_syncs"] == 1


def _blob_embeddings(labels, seed):
    """Offsets to each blob's centroid with noise (x-first channels), a low
    uncertainty inside the blobs and a high one outside."""
    rng = np.random.default_rng(seed)
    ndim = labels.ndim
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in labels.shape], indexing="ij"))
    emb = np.zeros((ndim + 1, *labels.shape), np.float32)
    for i in np.unique(labels[labels > 0]):
        m = labels == i
        for axis in range(ndim):
            channel = ndim - 1 - axis
            emb[channel][m] = grid[axis][m].mean() - grid[axis][m] + rng.normal(0, 0.4, m.sum())
    emb[ndim] = np.where(labels > 0, rng.uniform(0.0, 0.1, labels.shape),
                         rng.uniform(0.4, 1.0, labels.shape))
    return emb


@pytest.mark.parametrize("ndim", [2, 3])
def test_greedy_matches_jax_on_blob_fixtures(blob_container_2d, blob_container_3d, ndim):
    container = blob_container_2d if ndim == 2 else blob_container_3d
    labels = zarr.open(container, "r")["groundtruth"][0, 0]
    emb = _blob_embeddings(labels, seed=ndim)
    fg = emb[-1] < 0.3
    stats = {}
    mine = greedy_cluster(emb, fg, bandwidth=4.0, min_object_size=10, device="cpu",
                          stats=stats)
    ref = jax_greedy_cluster(emb, fg, bandwidth=4.0, min_object_size=10)
    np.testing.assert_array_equal(mine, ref)
    assert stats["instances"] == len(np.unique(ref)) - 1 > 5
    assert stats["iterations"] >= stats["instances"]
    # each instance's seed lies in it (no later proposal took it over here)
    np.testing.assert_array_equal(mine.ravel()[stats["seeds"]],
                                  np.arange(1, stats["instances"] + 1))


# -- the seeds of seeded mean shift -----------------------------------------------------


def _offset_fields():
    """tests/test_detect_variants.py's fields: 2D, 3D and a large 2D one."""
    rng = np.random.default_rng(7)
    fields = []
    for shape in ((61, 53), (17, 29, 23)):
        x = rng.random(shape).astype(np.float32)
        fields.append(gaussian_filter(x, 3.0) + 0.01 * rng.random(shape).astype(np.float32))
    fields.append(gaussian_filter(rng.random((512, 512)).astype(np.float32), 3.0))
    return fields


@pytest.mark.parametrize("which", [0, 1, 2])
def test_smooth_peak_seeds_match_jax_and_scipy(which):
    """Coordinates exactly the scipy oracle's and the JAX package's (as a
    set); the order may swap only peaks whose smoothed values tie within
    rtol 1e-5 (the contract of ``smooth_peak_seeds``)."""
    x = _offset_fields()[which]
    smooth = gaussian_filter(x, sigma=2)
    oracle = peaks.peak_local_max(-smooth)
    np.testing.assert_array_equal(oracle, jax_peaks.peak_local_max(-smooth))
    expect = np.flip(oracle, 1).astype(np.float32)
    got = peaks.smooth_peak_seeds(x, sigma=2.0, device="cpu")
    ref = jax_peaks.smooth_peak_seeds(x, sigma=2.0)
    assert got.shape == expect.shape == ref.shape
    assert len(got) > 5 or x.ndim == 3  # that small 3D field smooths to no minimum
    for other in (expect, ref):
        assert set(map(tuple, got.tolist())) == set(map(tuple, other.tolist()))
        swapped = (got != other).any(1)
        if swapped.any():
            vals_got = smooth[tuple(np.flip(got[swapped], 1).astype(int).T)]
            vals_other = smooth[tuple(np.flip(other[swapped], 1).astype(int).T)]
            np.testing.assert_allclose(vals_got, vals_other, rtol=1e-5)


def test_smooth_peak_seeds_cross_check_flag(monkeypatch):
    """CELLULUS_TPU_CHECK_SEEDS re-runs the scipy oracle: silent when the
    seeds agree, a warning when their coordinates diverge."""
    x = gaussian_filter(np.random.default_rng(3).random((41, 37)).astype(np.float32), 3.0)
    monkeypatch.setenv("CELLULUS_TPU_CHECK_SEEDS", "1")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        peaks.smooth_peak_seeds(x, sigma=2.0, device="cpu")
    assert not [m for m in w if "diverged" in str(m.message)]
    monkeypatch.setattr(peaks, "peak_local_max", lambda image, min_distance: np.zeros((0, 2)))
    with pytest.warns(RuntimeWarning, match="diverged"):
        peaks.smooth_peak_seeds(x, sigma=2.0, device="cpu")


# -- seeded mean shift, the sweep, device detect ----------------------------------------


def _synthetic_embeddings(h=48, w=48, centers=((12, 12), (34, 34)), r=6):
    """tests/test_detect_variants.py's two disks."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    emb = np.zeros((3, h, w), np.float32)
    emb[2] = 1.0
    for cy, cx in centers:
        mask = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
        emb[0][mask] = cx - xx[mask]
        emb[1][mask] = cy - yy[mask]
        emb[2][mask] = 0.05
    return emb


def _both(emb, seed=0, **settings):
    """detect_sample of both packages on ``emb`` with ``settings``."""
    mine = detect_sample(emb, InferenceConfig(**settings), 2, np.random.default_rng(seed), "cpu")
    ref = jax_detect_sample(emb, JaxInferenceConfig(**settings), 2,
                            np.random.default_rng(seed))
    return mine, ref


def _assert_same(mine, ref, threshold_rtol=0.0):
    np.testing.assert_allclose(mine[0], ref[0], rtol=threshold_rtol)
    for a, b in zip(mine[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)


def test_seeded_detect_sample_matches_jax():
    mine, ref = _both(_synthetic_embeddings(), bandwidth=8.0, use_seeds=True, min_size=0,
                      reduction_probability=1.0)
    _assert_same(mine, ref)
    ids = np.unique(mine[3][0])
    assert len(ids[ids > 0]) >= 2


def _clustered_points(rng, centers, n=60, spread=0.5):
    return np.concatenate([rng.normal(c, spread, size=(n, 2)) for c in centers]).astype(np.float32)


@pytest.mark.parametrize("reduction", [1.0, 0.5])
def test_sweep_matches_jax(reduction):
    """tests/test_bandwidth_sweep.py's points: the sweep against the JAX
    package's sweep (one subsample draw for both bandwidths), and at full
    sampling against each package's serial path."""
    X = _clustered_points(np.random.default_rng(0), [[0, 0], [10, 10], [0, 12]])
    bandwidths = [3.0, 1.5]
    mine = mean_shift_sweep_fit_predict(X, bandwidths, reduction_probability=reduction,
                                        rng=np.random.default_rng(4), device="cpu")
    ref = jax_sweep(X, bandwidths, reduction_probability=reduction,
                    rng=np.random.default_rng(4))
    np.testing.assert_array_equal(mine, ref)
    if reduction == 1.0:
        for k, bw in enumerate(bandwidths):
            serial = mean_shift_fit_predict(X, bw, None, device="cpu")
            np.testing.assert_array_equal(serial, jax_fit_predict(X, bw, None))
            np.testing.assert_array_equal(mine[k], serial)


def test_detect_sample_with_the_sweep_matches_jax():
    settings = dict(bandwidth=8.0, num_bandwidths=2, min_size=0, reduction_probability=1.0)
    mine, ref = _both(_synthetic_embeddings(), seed=1, vectorized_bandwidth_sweep=True,
                      **settings)
    _assert_same(mine, ref)
    serial = detect_sample(_synthetic_embeddings(), InferenceConfig(**settings), 2,
                           np.random.default_rng(1), "cpu")
    np.testing.assert_array_equal(mine[3], serial[3])


def _random_embeddings():
    """tests/test_detect_variants.py:107's fixture."""
    rng = np.random.default_rng(3)
    emb = rng.normal(0, 5.0, size=(3, 48, 52)).astype(np.float32)
    emb[-1] = rng.random((48, 52)).astype(np.float32)
    return emb


_DEVICE_DETECT = dict(crop_size=[36, 36], bandwidth=6.0, num_bandwidths=2,
                      reduction_probability=0.4)


@pytest.mark.parametrize("threshold", ["fixed", "quantile", "otsu"])
def test_device_detect_matches_the_host_path_and_jax(threshold, monkeypatch):
    """Device detect against the port's host path on the same RNG stream
    (the same detections; the threshold within rtol 1e-5: float32 on the
    device, float64 on the host), and against the JAX package's device
    detect (the same threshold and detections)."""
    emb = _random_embeddings()
    settings = dict(_DEVICE_DETECT, **{"fixed": dict(threshold=0.7),
                                       "quantile": dict(threshold_quantile=35.0),
                                       "otsu": {}}[threshold])
    ic = InferenceConfig(**settings, device_detect=True)
    on_device = detect_sample(emb, ic, 2, np.random.default_rng([1, 0]), "cpu")
    monkeypatch.setenv("CELLULUS_TPU_DEVICE_DETECT", "1")
    via_env = detect_sample(emb, InferenceConfig(**settings), 2, np.random.default_rng([1, 0]),
                            "cpu")
    ref = jax_detect_sample(emb, JaxInferenceConfig(**settings), 2,
                            np.random.default_rng([1, 0]))
    monkeypatch.delenv("CELLULUS_TPU_DEVICE_DETECT")
    host = detect_sample(emb, InferenceConfig(**settings), 2, np.random.default_rng([1, 0]),
                         "cpu")
    # the JAX package's compiled program rounds the quantile's interpolation
    # in its own way (the eager jnp.quantile is matched exactly, below)
    _assert_same(on_device, ref, threshold_rtol=1e-6 if threshold == "quantile" else 0.0)
    _assert_same(via_env, on_device)
    assert len(np.unique(on_device[3])) > 3
    if threshold != "otsu":  # the host's Otsu histogram is float64, the device's float32
        _assert_same(on_device, host, threshold_rtol=1e-5)
    off = detect_sample(emb, InferenceConfig(**settings, device_detect=False), 2,
                        np.random.default_rng([1, 0]), "cpu")
    _assert_same(off, host)


def test_device_thresholds_match_jax():
    """Otsu and the quantile on the device against the JAX package's on
    the same values: equal."""
    import jax.numpy as jnp

    from cellulus_tpu.ops.otsu import threshold_otsu_jax

    rng = np.random.default_rng(11)
    for _ in range(5):
        x = rng.gamma(2.0, 1.0, size=(67, 71)).astype(np.float32)
        assert float(threshold_otsu_device(torch.from_numpy(x))) == float(
            threshold_otsu_jax(jnp.asarray(x)))
        q = np.float32(rng.uniform(0, 100)) / np.float32(100)
        assert quantile_device(torch.from_numpy(x), q) == float(jnp.quantile(jnp.asarray(x), q))


# -- a 2D infer slice per variant --------------------------------------------------------


_VARIANTS = {
    "greedy": dict(clustering="greedy"),
    "seeds": dict(use_seeds=True),
    "sweep": dict(vectorized_bandwidth_sweep=True, num_bandwidths=2),
    "device_detect": dict(device_detect=True),
}


def _slice_config(container, out, checkpoint, device=None, **variant):
    def ds(name, secondary=None):
        d = {"container_path": str(out), "dataset_name": name}
        if secondary:
            d["secondary_dataset_name"] = secondary
        return d

    ic = {
        "crop_size": [68, 68],
        "num_infer_iterations": 2,
        "p_salt_pepper": 0.1,
        "dataset_config": {"container_path": str(container), "dataset_name": "train"},
        "detection_dataset_config": ds("detection", "embeddings"),
        "segmentation_dataset_config": ds("segmentation", "detection"),
        **variant,
    }
    if device is not None:
        ic["device"] = device
    return {
        "object_size": 10,
        "model_config": {"num_fmaps": 8, "fmap_inc_factor": 2, "features_in_last_layer": 16,
                         "checkpoint": str(checkpoint)},
        "inference_config": ic,
    }


@pytest.fixture(scope="module")
def variant_runs(blob_container_2d, tmp_path_factory):
    """The JAX package's noisy embeddings of blob_container_2d; then for
    each variant the JAX package's detect and segment, the port's detect on
    the JAX package's embeddings and the port's segment on the JAX
    package's detections, each through ``infer``."""
    work = tmp_path_factory.mktemp("torch_variants")
    checkpoint = work / "weights.pth"
    save_torch_checkpoint(checkpoint, init_params(jax.random.PRNGKey(0),
                                                  UNetSpec(1, 2, 8, 2, 16, ((2, 2),), 2)))
    source = work / "embeddings.zarr"
    config = _slice_config(blob_container_2d, source, checkpoint)
    config["inference_config"].update(
        prediction_dataset_config={"container_path": str(source), "dataset_name": "embeddings"},
        detection_dataset_config=None, segmentation_dataset_config=None)
    cellulus_tpu.infer(JaxExperimentConfig(**config))
    outs = {"embeddings": zarr.open(source, "r")["embeddings"]}

    def copy(name, out, dataset):
        f = zarr.open(out, "a")
        f[dataset] = name[...]
        f[dataset].attrs.update(name.attrs.asdict())

    for variant, settings in _VARIANTS.items():
        ref = work / f"{variant}-jax.zarr"
        copy(outs["embeddings"], ref, "embeddings")
        cellulus_tpu.infer(JaxExperimentConfig(**_slice_config(
            blob_container_2d, ref, checkpoint, **settings)))
        ref = zarr.open(ref, "r")
        for stage in ("detect", "segment"):
            out = work / f"{variant}-torch-{stage}.zarr"
            copy(ref["embeddings" if stage == "detect" else "detection"], out,
                 "embeddings" if stage == "detect" else "detection")
            config = ExperimentConfig(**_slice_config(
                blob_container_2d, out, checkpoint, "cpu", **settings))
            if stage == "detect":
                config.inference_config.segmentation_dataset_config = None
            else:
                config.inference_config.detection_dataset_config = None
            cellulus_tpu_torch.infer(config)
            outs[variant, stage] = zarr.open(out, "r")
        outs[variant, "jax"] = ref
    return outs


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_infer_slice_per_variant_matches_jax(variant_runs, variant):
    """Each stage on the JAX package's input. Greedy and device detect:
    the same partitions. Seeded mean shift and the sweep: every pixel where
    the detections disagree is explained by rounding (``detect_parity``:
    a kept centre that parted ways, at most 3 a bandwidth, or predict
    rounding); the segmentations of the same detections are the same."""
    from cellulus_tpu_torch.utils.parity import mean_shift_fit_inputs, unexplained_mean_shift
    from tests import detect_parity

    ref = variant_runs[variant, "jax"]
    mine = variant_runs[variant, "detect"]["detection"]
    k = 2 if variant == "sweep" else 1
    assert mine.shape == ref["detection"].shape == (2, k, 128, 128)
    np.testing.assert_array_equal(variant_runs[variant, "detect"]["binary-segmentation"][...],
                                  ref["binary-segmentation"][...])
    ic = ExperimentConfig(**_slice_config("c", "o", "w", **_VARIANTS[variant])).inference_config
    ic.bandwidth = 5.0  # 0.5 x object_size
    for s in range(2):
        fits = None
        for b in range(k):
            assert len(np.unique(mine[s, b])) > 3
            if _same_partition(mine[s, b], ref["detection"][s, b]):
                continue
            assert variant in ("seeds", "sweep"), (s, b)
            fits = fits or mean_shift_fit_inputs(variant, variant_runs["embeddings"][s], ic, s)
            mask, X, X_fit, seeds, bandwidth = fits[b]
            bw2 = float(np.float32(bandwidth) ** 2)
            bad, p_mine, p_theirs = unexplained_mean_shift(
                mine[s, b], ref["detection"][s, b], mask, X,
                detect_parity.kept_centres_port(X_fit, seeds, bandwidth),
                detect_parity.kept_centres_jax(X_fit, seeds, bandwidth), bw2)
            assert bad == [] and p_mine <= 3 and p_theirs <= 3, (s, b, bad, p_mine, p_theirs)
        for b in range(k):
            assert _same_partition(variant_runs[variant, "segment"]["segmentation"][s, b],
                                   ref["segmentation"][s, b])
