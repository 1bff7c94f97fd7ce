"""Pipelined inference: predict / detect / segment overlap across samples.

Port of ``cellulus_tpu/pipeline.py``. The staged path runs
each stage over all samples before the next starts; this one streams:
while the calling thread predicts sample ``s + 1``'s tiles, a stage worker
takes sample ``s`` through detect and segment, and every zarr write goes
through one single-writer I/O thread. The outputs are the staged path's
bit for bit: the same stage functions on the same arrays, and the same
per-sample random streams (predict's generator from ``(seed, sample)``,
detect's ``sample_rng(seed, sample)``), whatever the scheduling.

On CUDA each stage worker launches on its own stream, so a worker's host
fetches wait for its own kernels only, and predict's for predict's: on one
shared stream every ``.cpu()`` would wait for the other thread's queued
work and the pipeline would run as a queue. The workers' streams have the
higher priority, so their small kernels take SMs ahead of predict's queued
conv blocks, and predict fetches its tile batches through pinned memory
(``predict._HostSlots``), which does not block the workers' CUDA calls
while it waits.
Detect uploads the sample's host embeddings on the worker's stream (no
device tensor crosses threads).

Over several devices predict splits each tile batch over them, and sample
``s``'s detect and segment run on ``devices[s % n]``, on the worker's
stream of that device; there are as many workers as devices, at least two.

``infer()`` takes this path when ``inference_config.pipelined`` is set and
the prediction, detection and segmentation configs are all present.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import threading
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from .configs import InferenceConfig
from .datasets import normalization_factor_for
from .detect import detect_sample, sample_rng
from .io import DatasetMetaData, zarr
from .io.meta_data import spatial_attrs
from .models import UNet, compute_geometry
from .parallel.mesh import as_devices, local_devices, replicate
from .predict import predict_sample
from .segment import segment_sample
from .utils.profiling import span

# stage workers: detect/segment of one sample overlaps the next sample's
# predict; a second worker keeps host glue and device work of two samples
# overlapping (the JAX package's max(2, number of devices))
STAGE_WORKERS = 2
# the stage workers' CUDA streams run at a higher priority than predict's
# (lower is higher; predict's stream has 0): K1's blocks fill every SM, and
# at equal priority each of a worker's small kernels waits behind a wave of
# them, which made a sample's detect+segment some 15x slower than alone
WORKER_STREAM_PRIORITY = -1


def stage_workers_for(inference_config: InferenceConfig, meta: DatasetMetaData,
                      num_stage_workers: int) -> int:
    """Cap the stage workers so the in-flight samples fit the host-RAM budget.

    Every in-flight sample holds its ``(D + 1, *spatial)`` float32
    embeddings, and while its worker runs detect also the mean-centred copy
    (same shape and dtype) plus the per-bandwidth uint16 detections. The
    budget is ``inference_config.pipeline_ram_gb``, else the
    CELLULUS_TPU_PIPELINE_RAM_GB env var, else a quarter of physical RAM."""
    ic = inference_config
    spatial_px = int(np.prod(meta.spatial_array))
    emb_bytes = (meta.num_spatial_dims + 1) * spatial_px * 4
    sample_bytes = 2 * emb_bytes + ic.num_bandwidths * spatial_px * 2
    budget_gb = ic.pipeline_ram_gb
    if budget_gb is None:
        budget_gb = os.environ.get("CELLULUS_TPU_PIPELINE_RAM_GB")
    if budget_gb is not None:
        budget = float(budget_gb) * (1 << 30)
    else:
        try:
            budget = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") / 4
        except (ValueError, OSError):
            budget = 16 * (1 << 30)
    max_workers = max(1, int(budget // sample_bytes) - 1)
    if max_workers < num_stage_workers:
        warnings.warn(
            f"pipelined inference holds ~{sample_bytes / 1e9:.1f} GB per "
            f"in-flight sample (embeddings + detect's centered copy + "
            f"detections); capping stage workers "
            f"{num_stage_workers} -> {max_workers} to fit the host RAM "
            "budget (raise inference_config.pipeline_ram_gb or the "
            "CELLULUS_TPU_PIPELINE_RAM_GB env var to override)",
            RuntimeWarning,
            stacklevel=3,
        )
        return max_workers
    return num_stage_workers


def infer_pipelined(
    model: UNet,
    inference_config: InferenceConfig,
    normalization_factor: Optional[float],
    device,
    compute_dtype=torch.float32,
    intervals: Optional[Dict[str, Dict[int, tuple]]] = None,
    devices=None,
) -> None:
    """Predict, detect and segment every sample, overlapped across samples,
    into the five datasets the staged path writes (``embeddings``,
    ``detection``, ``binary-segmentation``, ``centered-embeddings``,
    ``segmentation`` under their configured names and containers).

    ``intervals``, when given, receives each sample's host-clock
    ``(start, end)`` of ``"predict"`` (calling thread), ``"detect"`` and
    ``"segment"`` (its worker), from ``time.perf_counter``.

    ``devices`` default to every visible GPU of ``device``'s type (one CPU).

    A failure in a worker or a write is raised here, after the loop."""
    ic = inference_config
    device = torch.device(device)
    devices = local_devices(device=device) if devices is None else as_devices(devices)
    replicas = replicate(model, devices) if len(devices) > 1 else None
    if intervals is not None:
        for name in ("predict", "detect", "segment"):
            intervals.setdefault(name, {})
    with span("pipeline: open"):
        meta = DatasetMetaData.from_dataset_config(ic.dataset_config)
        D = meta.num_spatial_dims
        num_stage_workers = stage_workers_for(ic, meta, max(STAGE_WORKERS, len(devices)))
        raw_ds = zarr.open(ic.dataset_config.container_path, "r")[ic.dataset_config.dataset_name]
        if normalization_factor is None:
            normalization_factor = normalization_factor_for(raw_ds.dtype)
        out_tile = compute_geometry(tuple(ic.crop_size), model.downsampling_factors).output_size
        ds_emb = zarr.open(ic.prediction_dataset_config.container_path, "a").create_dataset(
            ic.prediction_dataset_config.dataset_name,
            shape=(meta.num_samples, D + 1, *meta.spatial_array),
            dtype=np.float32,
            chunks=(1, D + 1, *out_tile),
            compressor=None,  # float embeddings do not compress
        )
        f_det = zarr.open(ic.detection_dataset_config.container_path, "a")
        ds_detection = f_det.create_dataset(
            ic.detection_dataset_config.dataset_name,
            shape=(meta.num_samples, ic.num_bandwidths, *meta.spatial_array),
            dtype=np.uint16,
        )
        ds_binary = f_det.create_dataset(
            "binary-segmentation", shape=(meta.num_samples, 1, *meta.spatial_array),
            dtype=np.uint16,
        )
        ds_centered = f_det.create_dataset(
            "centered-embeddings", shape=(meta.num_samples, D + 1, *meta.spatial_array),
            dtype=np.float32, compressor=None,
        )
        ds_seg = zarr.open(ic.segmentation_dataset_config.container_path, "a").create_dataset(
            ic.segmentation_dataset_config.dataset_name,
            shape=(meta.num_samples, ic.num_bandwidths, *meta.spatial_array),
            dtype=np.uint16,
        )
        for ds in (ds_emb, ds_detection, ds_binary, ds_centered, ds_seg):
            ds.attrs.update(spatial_attrs(meta))
    nucleus = ic.post_processing == "nucleus"

    local = threading.local()

    def worker_stream(dev):
        if dev.type != "cuda":
            return contextlib.nullcontext()
        if not hasattr(local, "streams"):
            local.streams = {}
        if dev not in local.streams:
            local.streams[dev] = torch.cuda.Stream(dev, priority=WORKER_STREAM_PRIORITY)
        return torch.cuda.stream(local.streams[dev])

    # permits = workers that can hold a finished sample + the one sample the
    # predict loop is assembling: bounds how far predict runs ahead
    inflight = threading.BoundedSemaphore(num_stage_workers + 1)
    write_futures = []

    def write(ds, sel, value):
        write_futures.append(io_pool.submit(ds.__setitem__, sel, value))

    def process_sample(sample: int, embeddings: np.ndarray) -> None:
        """Detect and segment one sample in a worker thread."""
        try:
            label = f"detect+segment sample {sample}"
            dev = devices[sample % len(devices)] if len(devices) > 1 else device
            with span(label), worker_stream(dev):
                t0 = time.perf_counter()
                threshold, binary_mask, centered, detections = detect_sample(
                    embeddings, ic, D, sample_rng(ic.seed, sample), dev, devices=devices)
                t1 = time.perf_counter()
                print(f"For sample {sample}, binary threshold {threshold} was used.")
                raw_image = np.asarray(raw_ds[sample, 0]) if nucleus else None
                segs = []
                for k in range(ic.num_bandwidths):
                    with span("segment: sample"):
                        segs.append(segment_sample(detections[k], raw_image, ic, dev))
                t2 = time.perf_counter()
            write(ds_binary, (sample, 0), binary_mask.astype(np.uint16))
            write(ds_centered, sample, centered)
            write(ds_detection, sample, detections)
            for k, seg in enumerate(segs):
                write(ds_seg, (sample, k), seg)
            if intervals is not None:
                intervals["detect"][sample] = (t0, t1)
                intervals["segment"][sample] = (t1, t2)
        finally:
            inflight.release()

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as io_pool, \
            concurrent.futures.ThreadPoolExecutor(max_workers=num_stage_workers) as stage_pool:
        stage_futures = []
        for sample in range(meta.num_samples):
            with span("pipeline: slot wait"):
                inflight.acquire()
            with span(f"predict sample {sample}"):
                t0 = time.perf_counter()
                with span("predict: read"):
                    raw = np.asarray(raw_ds[sample], dtype=np.float32)
                embeddings = predict_sample(model, raw, ic, float(normalization_factor),
                                            sample, device, compute_dtype, devices=devices,
                                            replicas=replicas)
                t1 = time.perf_counter()
            if intervals is not None:
                intervals["predict"][sample] = (t0, t1)
            write(ds_emb, sample, embeddings)
            stage_futures.append(stage_pool.submit(process_sample, sample, embeddings))
        with span("pipeline: drain"):
            for fut in stage_futures:
                fut.result()
            # every write is submitted once its sample's stage is done
            for fut in list(write_futures):
                fut.result()
