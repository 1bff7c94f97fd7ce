"""Segment stage: detections -> post-processed instances.

Port of ``cellulus_tpu/segment.py`` (``cell_segment_sample``,
``nucleus_partition``, ``segment``), 2D and 3D. Two post-processing modes:

- "cell": halo removal (grow by ``grow_distance``, then shrink by
  ``shrink_distance``) as disk convolutions on the device;
- "nucleus": per instance, an Otsu threshold of the raw image's values
  under the instance and hole filling: on the host, one instance at a time
  inside its bounding box (the JAX package's host path), or with
  ``device_nucleus`` all instances at once on the device
  (``ops/nucleus.py``, the JAX package's device path).

Both end with connected components (full connectivity: 8 in 2D, 26 in 3D),
the ``min_size`` filter and a consecutive relabel on the device
(``ops/components.py:size_filter_device``); only uint16 labels come back to
the host. With ``min_size == 0`` the post-processed detections are kept as
they are, without relabelling, as in the reference.

Over several devices the (sample, bandwidth) jobs take the devices in turn,
a worker thread a device (``cellulus_tpu/segment.py:_run_device_jobs``).
"""

from __future__ import annotations

import concurrent.futures
import itertools

import numpy as np
import torch
from scipy.ndimage import binary_fill_holes, find_objects

from .configs import InferenceConfig
from .io import DatasetMetaData, zarr
from .io.meta_data import spatial_attrs
from .ops.components import size_filter_device
from .ops.morphology import halo_removal
from .ops.nucleus import nucleus_partition_device
from .ops.otsu import threshold_otsu
from .parallel.mesh import as_devices, local_devices
from .utils.env import resolve_flag
from .utils.profiling import time_device
from .utils.progress import progress


def want_device_nucleus(inference_config: InferenceConfig) -> bool:
    """The ``device_nucleus`` config field when set, else the
    ``CELLULUS_TPU_DEVICE_NUCLEUS`` env var (``cellulus_tpu/segment.py:29-40``)."""
    return resolve_flag(inference_config.device_nucleus, "CELLULUS_TPU_DEVICE_NUCLEUS")


def _check_uint16_range(segmentation: np.ndarray) -> None:
    if segmentation.dtype != np.uint16 and segmentation.size:
        lo, hi = segmentation.min(), segmentation.max()
        if lo < 0 or hi > np.iinfo(np.uint16).max:
            raise ValueError(
                f"segment needs uint16-range labels, got [{lo}, {hi}] "
                f"in dtype {segmentation.dtype}"
            )


def _to_device(array: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array, dtype=dtype)).to(device)


def _size_filter(labels: torch.Tensor, min_size: int, dtype) -> np.ndarray:
    """The size filter on the labels' device; the uint16 labels come down
    and are returned in ``dtype``."""
    return _fetch(time_device("segment.device", size_filter_device, labels, int(min_size)),
                  dtype)


def _fetch(labels: torch.Tensor, dtype) -> np.ndarray:
    return labels.cpu().numpy().astype(dtype, copy=False)


def cell_segment_sample(
    segmentation: np.ndarray,
    grow_distance: float,
    shrink_distance: float,
    min_size: int,
    device,
) -> np.ndarray:
    """Halo removal, connected components, size filter and relabel of one
    2D or 3D label image in one pass on ``device``
    (``cellulus_tpu/segment.py:cell_segment_sample``): uint16 detections go
    up, uint16 labels come down, returned in the input's dtype."""
    _check_uint16_range(segmentation)

    def run(seg):
        seg = halo_removal(seg, float(grow_distance), float(shrink_distance))
        return size_filter_device(seg, int(min_size))

    labels = time_device("segment.device", run, _to_device(segmentation, np.int32, device))
    return _fetch(labels, segmentation.dtype)


def nucleus_segment_sample(segmentation: np.ndarray, raw_image: np.ndarray, min_size: int,
                           device) -> np.ndarray:
    """The device nucleus partition (``ops/nucleus.py``) and the size filter
    of one label image on ``device``, as the JAX package's device path
    (``cellulus_tpu/segment.py:255-263``)."""
    _check_uint16_range(segmentation)

    def run(seg, raw):
        return size_filter_device(nucleus_partition_device(seg, raw), int(min_size))

    labels = time_device("segment.device", run, _to_device(segmentation, np.int32, device),
                         _to_device(raw_image, np.float32, device))
    return _fetch(labels, segmentation.dtype)


def nucleus_partition(segmentation: np.ndarray, raw_image: np.ndarray) -> np.ndarray:
    """Per-instance intensity Otsu + hole filling ("nucleus" mode,
    reference ``segment.py:52-101``), a copy of
    ``cellulus_tpu/segment.py:nucleus_partition``.

    Each instance's work stays inside its bounding box (``find_objects``):
    the raw values under the instance are thresholded with Otsu (the whole
    instance is kept where they are constant), the mask is hole-filled and
    written with the instance's id.
    """
    out = np.zeros_like(segmentation)
    seg_int = segmentation.astype(np.int64, copy=False)
    for idx, bbox in enumerate(find_objects(seg_int)):
        if bbox is None:
            continue
        id_ = idx + 1
        sub_seg = seg_int[bbox]
        sub_raw = raw_image[bbox]
        id_mask = sub_seg == id_
        values = sub_raw[id_mask]
        if values.max() == values.min():
            mask = id_mask
        else:
            mask = id_mask & (sub_raw > threshold_otsu(values))
        out[bbox][binary_fill_holes(mask)] = id_
    return out


def segment_sample(detections: np.ndarray, raw_image, inference_config: InferenceConfig,
                   device) -> np.ndarray:
    """One bandwidth's detections of one sample -> uint16 instances, by the
    configured post-processing (``raw_image``: the sample's raw channel 0,
    read in "nucleus" mode only). The segment stage and the pipelined path
    both call it."""
    ic = inference_config
    if ic.post_processing == "cell":
        seg = cell_segment_sample(detections, ic.grow_distance, ic.shrink_distance,
                                  ic.min_size, device)
    elif want_device_nucleus(ic):
        seg = nucleus_segment_sample(detections, raw_image, ic.min_size, device)
    else:
        seg = _size_filter(_to_device(nucleus_partition(detections, raw_image), np.int32,
                                      device), ic.min_size, np.uint16)
    return seg.astype(np.uint16)


def segment(inference_config: InferenceConfig, device, devices=None) -> None:
    """Segment stage over every sample and bandwidth; over several
    ``devices`` (default: every visible GPU of ``device``'s type, one CPU)
    job ``j`` of the (sample, bandwidth) jobs runs on ``devices[j % n]``."""
    ic = inference_config
    devices = local_devices(device=device) if devices is None else as_devices(devices)
    nucleus = ic.post_processing == "nucleus"
    meta = DatasetMetaData.from_dataset_config(ic.dataset_config)
    f = zarr.open(ic.segmentation_dataset_config.container_path, "a")
    ds_in = f[ic.segmentation_dataset_config.secondary_dataset_name]
    ds_out = f.create_dataset(
        ic.segmentation_dataset_config.dataset_name,
        shape=(meta.num_samples, ic.num_bandwidths, *meta.spatial_array),
        dtype=np.uint16,
    )
    ds_out.attrs.update(spatial_attrs(meta))
    if nucleus:
        # the raw image lives in its own container: the reference reads it
        # from the segmentation container (reference segment.py:53), which
        # works only when the two are one (cellulus_tpu/segment.py:222-230)
        ds_raw = zarr.open(ic.dataset_config.container_path, "r")[
            ic.dataset_config.dataset_name]
    label = "segment" if not nucleus else (
        "segment (nucleus, device)" if want_device_nucleus(ic) else "segment (nucleus)")
    if len(devices) > 1:
        jobs = list(itertools.product(range(meta.num_samples), range(ic.num_bandwidths)))

        def job(j: int) -> None:
            sample, k = jobs[j]
            raw_image = np.asarray(ds_raw[sample, 0]) if nucleus else None
            ds_out[sample, k] = segment_sample(np.asarray(ds_in[sample, k]), raw_image, ic,
                                               devices[j % len(devices)])

        workers = max(2, min(len(devices), len(jobs)))
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
            list(progress(pool.map(job, range(len(jobs))), label, total=len(jobs)))
        return
    for sample in progress(range(meta.num_samples), label, total=meta.num_samples):
        raw_image = np.asarray(ds_raw[sample, 0]) if nucleus else None
        for k in range(ic.num_bandwidths):
            ds_out[sample, k] = segment_sample(np.asarray(ds_in[sample, k]), raw_image, ic,
                                               device)
