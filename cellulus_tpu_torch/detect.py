"""Detect stage: embeddings zarr -> instance detections zarr.

Port of the default branch of ``cellulus_tpu/detect.py:detect_sample``
(mean shift, no seeds), 2D and 3D: a threshold on the uncertainty channel
(fixed, quantile or Otsu, on the host), the foreground mask ``std <
threshold``, mean-centred embeddings, then per bandwidth ``bandwidth /
2**k`` a mean-shift segmentation of the absolute embeddings on the device.

Outputs (the JAX package's layouts): ``detection`` ``(s, num_bandwidths,
*spatial)`` uint16, ``binary-segmentation`` ``(s, 1, *spatial)`` uint16 and
``centered-embeddings`` ``(s, D + 1, *spatial)`` float32.
"""

from __future__ import annotations

import numpy as np

from .configs import InferenceConfig
from .io import DatasetMetaData, zarr
from .io.meta_data import spatial_attrs
from .ops.mean_shift import mean_shift_segmentation
from .ops.otsu import threshold_otsu


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


def _check_supported(ic: InferenceConfig) -> None:
    unported = {
        "use_seeds": (ic.use_seeds, "M10, detect variants: use_seeds"),
        "clustering='greedy'": (ic.clustering == "greedy", "M10, detect variants: greedy"),
        "device_detect": (bool(ic.device_detect), "M10, detect variants: device_detect"),
        "vectorized_bandwidth_sweep": (
            ic.vectorized_bandwidth_sweep, "M10, detect variants: bandwidth sweep"
        ),
    }
    for name, (on, item) in unported.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP: {item})")


def detect_sample(
    embeddings: np.ndarray,
    inference_config: InferenceConfig,
    num_spatial_dims: int,
    rng: np.random.Generator,
    device,
):
    """Detect instances in one sample's ``(D + 1, *spatial)`` embeddings.

    Returns ``(threshold, binary_mask, centered_embeddings, detections
    (num_bandwidths, *spatial) uint16)``.
    """
    ic = inference_config
    _check_supported(ic)
    embeddings = np.asarray(embeddings, dtype=np.float32)
    embeddings_std = embeddings[-1]
    if ic.threshold is not None:
        threshold = ic.threshold
    elif ic.threshold_quantile is not None:
        threshold = float(np.percentile(embeddings_std, ic.threshold_quantile))
    else:
        threshold = threshold_otsu(embeddings_std)

    binary_mask = embeddings_std < threshold
    centered = mean_center_embeddings(embeddings, binary_mask)
    detections = np.zeros((ic.num_bandwidths, *embeddings_std.shape), dtype=np.uint16)
    for k in range(ic.num_bandwidths):
        segmentation = mean_shift_segmentation(
            embeddings[:num_spatial_dims],
            embeddings_std,
            bandwidth=ic.bandwidth / (2**k),
            reduction_probability=ic.reduction_probability,
            threshold=threshold,
            max_iter=ic.mean_shift_max_iterations,
            rng=rng,
            device=device,
        )
        detections[k] = segmentation.astype(np.uint16)
    return threshold, binary_mask, centered, detections


def detect(inference_config: InferenceConfig, device) -> None:
    ic = inference_config
    _check_supported(ic)
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
