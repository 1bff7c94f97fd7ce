"""Detect stage: embeddings zarr -> instance detections zarr.

Port of ``cellulus_tpu/detect.py:detect_sample``, 2D and 3D, with its
branches in its order:

- device detect (``device_detect``, or the ``CELLULUS_TPU_DEVICE_DETECT``
  environment variable when the field is unset; mean shift without seeds
  or sweep): threshold (fixed, quantile or Otsu), mask, coordinate grid and
  the gather of the fit subsample on the device; the host gets the mask,
  the subsample for bin seeding and the uint16 detections;
- otherwise a threshold on the host, the foreground mask ``std <
  threshold`` and the mean-centred embeddings, then per bandwidth
  ``bandwidth / 2**k``:
  - the bandwidth sweep (``vectorized_bandwidth_sweep``, more than one
    bandwidth, no seeds): every bandwidth over one fit subsample draw;
  - mean shift on the device, of the absolute embeddings, or with
    ``use_seeds`` of the centred ones from seeds at the minima of the
    smoothed offset magnitude (computed once a sample);
  - greedy clustering (``clustering = "greedy"``) on the device.

Outputs (the JAX package's layouts): ``detection`` ``(s, num_bandwidths,
*spatial)`` uint16, ``binary-segmentation`` ``(s, 1, *spatial)`` uint16 and
``centered-embeddings`` ``(s, D + 1, *spatial)`` float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs import InferenceConfig
from .io import DatasetMetaData, zarr
from .io.meta_data import spatial_attrs
from .ops import mean_shift as ms
from .ops.greedy_cluster import greedy_cluster
from .ops.mean_shift import mean_shift_segmentation, mean_shift_sweep_fit_predict
from .ops.otsu import quantile_device, threshold_otsu, threshold_otsu_device
from .ops.peaks import smooth_peak_seeds
from .utils.env import resolve_flag
from .utils.profiling import time_device


def want_device_detect(inference_config: InferenceConfig) -> bool:
    """The ``device_detect`` field when set, else the
    ``CELLULUS_TPU_DEVICE_DETECT`` environment variable."""
    return resolve_flag(inference_config.device_detect, "CELLULUS_TPU_DEVICE_DETECT")


def sample_rng(seed: int, sample: int) -> np.random.Generator:
    """Per-sample host RNG stream of the fit subsample, as in the JAX package."""
    return np.random.default_rng([int(seed), int(sample)])


def mean_center_embeddings(embeddings: np.ndarray, binary_mask: np.ndarray) -> np.ndarray:
    """Subtract the foreground-mean offset per channel.

    Reference quirk kept: the mean is over foreground values that are
    exactly non-zero (masked-out entries become 0 and are excluded by value,
    which also drops true zeros).
    """
    centered = np.array(embeddings, dtype=np.float32, copy=True)
    for channel in range(embeddings.shape[0] - 1):
        masked = embeddings[channel] * binary_mask
        nonzero = masked[masked != 0]
        if len(nonzero):
            centered[channel] -= nonzero.mean()
    return centered


def _meanshift_detect_device(embeddings: np.ndarray, D: int, ic: InferenceConfig,
                             rng: np.random.Generator, device):
    """Mean-shift detections for every bandwidth, prepared on the device
    (``cellulus_tpu/detect.py:_meanshift_detect_device``): the threshold
    (fixed, the quantile or Otsu), the mask, the coordinate grid and each
    bandwidth's fit subsample, gathered on the device from the host's draw
    (one ``rng.random(n)`` a bandwidth, as the host path draws it). Returns
    ``(threshold, binary_mask, detections (K, *spatial) uint16)``."""
    dev = torch.device(device)
    emb = torch.from_numpy(embeddings).to(dev)
    std = emb[-1]
    spatial = tuple(std.shape)
    if ic.threshold is not None:
        threshold = ic.threshold
    elif ic.threshold_quantile is not None:
        threshold = quantile_device(std, np.float32(ic.threshold_quantile) / np.float32(100.0))
    else:
        threshold = float(threshold_otsu_device(std))
    mask_t = (std < threshold).reshape(-1)
    absolute = emb[:D].clone()
    for channel in range(D):
        axis = D - 1 - channel  # x-first channel order
        shape = [1] * D
        shape[axis] = spatial[axis]
        absolute[channel] += torch.arange(spatial[axis], dtype=torch.float32,
                                          device=dev).reshape(shape)
    X_all = absolute.reshape(D, -1).T
    mask = mask_t.cpu().numpy()
    detections = np.zeros((ic.num_bandwidths, *spatial), dtype=np.uint16)
    flat_fg = np.flatnonzero(mask)
    if len(flat_fg) == 0:
        return threshold, mask.reshape(spatial), detections
    fg_t = torch.from_numpy(flat_fg).to(dev)
    X = X_all.index_select(0, fg_t)
    for k in range(ic.num_bandwidths):
        bandwidth = ic.bandwidth / (2**k)
        fit_idx = flat_fg
        if ic.reduction_probability < 1.0:
            fit_idx = flat_fg[rng.random(len(flat_fg)) < ic.reduction_probability]
            if len(fit_idx) == 0:
                fit_idx = flat_fg
        X_fit = X_all.index_select(0, torch.from_numpy(fit_idx).to(dev))
        seeds = ms.bin_seeds(X_fit.cpu().numpy(), bin_size=bandwidth)
        if len(seeds) == 0:
            continue
        centers, n_final = time_device("detect.device", ms.launch_fit, X_fit, seeds,
                                       bandwidth, ic.mean_shift_max_iterations)
        bw2 = ms.fit_thresholds(bandwidth)[0]
        kept = ms._dedupe(centers, n_final, bw2)
        labels = time_device("detect.device", ms._predict, X, kept, bw2)
        det = torch.zeros(len(mask), dtype=torch.int32, device=dev)
        det[fg_t] = (labels + 1).int()
        detections[k] = det.to(torch.int16).cpu().numpy().view(np.uint16).reshape(spatial)
    return threshold, mask.reshape(spatial), detections


def detect_sample(
    embeddings: np.ndarray,
    inference_config: InferenceConfig,
    num_spatial_dims: int,
    rng: np.random.Generator,
    device,
    stats=None,
):
    """Detect instances in one sample's ``(D + 1, *spatial)`` embeddings.

    ``stats``, when given, receives greedy clustering's per-bandwidth
    statistics (iterations, host syncs, instances).

    Returns ``(threshold, binary_mask, centered_embeddings, detections
    (num_bandwidths, *spatial) uint16)``.
    """
    ic = inference_config
    embeddings = np.asarray(embeddings, dtype=np.float32)
    embeddings_std = embeddings[-1]
    if (ic.clustering == "meanshift" and not ic.use_seeds
            and not ic.vectorized_bandwidth_sweep and want_device_detect(ic)):
        threshold, binary_mask, detections = _meanshift_detect_device(
            embeddings, num_spatial_dims, ic, rng, device)
        return threshold, binary_mask, mean_center_embeddings(embeddings, binary_mask), detections

    if ic.threshold is not None:
        threshold = ic.threshold
    elif ic.threshold_quantile is not None:
        threshold = float(np.percentile(embeddings_std, ic.threshold_quantile))
    else:
        threshold = threshold_otsu(embeddings_std)

    binary_mask = embeddings_std < threshold
    centered = mean_center_embeddings(embeddings, binary_mask)
    detections = np.zeros((ic.num_bandwidths, *embeddings_std.shape), dtype=np.uint16)
    bandwidths = [ic.bandwidth / (2**k) for k in range(ic.num_bandwidths)]

    if (ic.clustering == "meanshift" and ic.num_bandwidths > 1 and not ic.use_seeds
            and ic.vectorized_bandwidth_sweep):
        if binary_mask.sum() == 0:
            return threshold, binary_mask, centered, detections
        absolute = ms.add_coordinate_grid(embeddings[:num_spatial_dims])
        X = absolute.reshape(num_spatial_dims, -1).T[binary_mask.ravel()]
        labels = mean_shift_sweep_fit_predict(
            X, bandwidths, reduction_probability=ic.reduction_probability,
            max_iter=ic.mean_shift_max_iterations, rng=rng, device=device)
        for k in range(ic.num_bandwidths):
            spatial = np.full(binary_mask.shape, -1, np.int32)
            spatial[binary_mask] = labels[k]
            detections[k] = (spatial + 1).astype(np.uint16)
    elif ic.clustering == "meanshift":
        # seeds depend on the offset field only: computed once a sample
        seeds = None
        if ic.use_seeds:
            offset_magnitude = np.linalg.norm(centered[:-1], axis=0)
            seeds = smooth_peak_seeds(offset_magnitude, sigma=2.0, device=device)
        source = centered if ic.use_seeds else embeddings
        for k, bandwidth in enumerate(bandwidths):
            segmentation = mean_shift_segmentation(
                source[:num_spatial_dims],
                source[-1],
                bandwidth=bandwidth,
                reduction_probability=ic.reduction_probability,
                threshold=threshold,
                max_iter=ic.mean_shift_max_iterations,
                rng=rng,
                device=device,
                seeds=seeds,
            )
            detections[k] = segmentation.astype(np.uint16)
    else:  # greedy
        for k, bandwidth in enumerate(bandwidths):
            greedy_stats = {}
            segmentation = greedy_cluster(
                embeddings, fg_mask=binary_mask, bandwidth=bandwidth,
                min_object_size=ic.min_size, device=device, stats=greedy_stats)
            detections[k] = segmentation.astype(np.uint16)
            if stats is not None:
                stats.setdefault("greedy", []).append(greedy_stats)
    return threshold, binary_mask, centered, detections


def detect(inference_config: InferenceConfig, device) -> None:
    ic = inference_config
    meta = DatasetMetaData.from_dataset_config(ic.dataset_config)
    f = zarr.open(ic.detection_dataset_config.container_path, "a")
    ds_in = f[ic.detection_dataset_config.secondary_dataset_name]
    ds_detection = f.create_dataset(
        ic.detection_dataset_config.dataset_name,
        shape=(meta.num_samples, ic.num_bandwidths, *meta.spatial_array),
        dtype=np.uint16,
    )
    ds_binary = f.create_dataset(
        "binary-segmentation",
        shape=(meta.num_samples, 1, *meta.spatial_array),
        dtype=np.uint16,
    )
    ds_centered = f.create_dataset(
        "centered-embeddings",
        shape=(meta.num_samples, meta.num_spatial_dims + 1, *meta.spatial_array),
        dtype=np.float32,
        compressor=None,
    )
    for ds in (ds_detection, ds_binary, ds_centered):
        ds.attrs.update(spatial_attrs(meta))

    for sample in range(meta.num_samples):
        threshold, binary_mask, centered, detections = detect_sample(
            np.asarray(ds_in[sample], dtype=np.float32),
            ic,
            meta.num_spatial_dims,
            sample_rng(ic.seed, sample),
            device,
        )
        ds_binary[sample, 0] = binary_mask.astype(np.uint16)
        ds_centered[sample] = centered
        ds_detection[sample] = detections
        print(f"For sample {sample}, binary threshold {threshold} was used.")
