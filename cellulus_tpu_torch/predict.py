"""Tiled, test-time-augmented embedding prediction.

Port of ``cellulus_tpu/predict.py`` (single device), 2D and 3D: output
tiles cover the image or volume on a shingled grid, each tile is read with
its valid-conv context under reflect boundary handling in every axis, and
``tile_batch_size`` tiles at a time run all ``2 * num_infer_iterations``
noisy copies as one batched forward. The salt-and-pepper draws come from
one ``torch.Generator`` per sample, seeded from ``(inference_config.seed,
sample)``.
"""

from __future__ import annotations

import itertools
from typing import List

import numpy as np
import torch

from .configs import InferenceConfig
from .datasets import normalization_factor_for
from .io import DatasetMetaData, zarr
from .io.meta_data import spatial_attrs
from .io.regions import read_reflect_region
from .models import UNet, compute_geometry, tta_embeddings
from .utils.device import seeded_generator
from .utils.profiling import time_device


def tile_origins(extent: int, tile: int) -> List[int]:
    """Start offsets covering ``[0, extent)`` with stride ``tile``; the last
    tile is shifted inward (shingled) so every pixel is covered exactly."""
    if extent <= tile:
        return [0]
    origins = list(range(0, extent - tile, tile))
    origins.append(extent - tile)
    return origins


def _fetch(out: torch.Tensor) -> torch.Tensor:
    """``out`` on the host. From the card through a pinned buffer, copied
    asynchronously, then a wait on the stream: a copy into pageable memory
    blocks every other thread's CUDA calls (the pipelined path's stage
    workers) for as long as it waits for the stream."""
    if out.device.type != "cuda":
        return out
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    torch.cuda.current_stream(out.device).synchronize()
    return host


def predict_sample(
    model: UNet,
    raw: np.ndarray,
    inference_config: InferenceConfig,
    normalization_factor: float,
    sample_seed: int,
    device,
    compute_dtype=torch.float32,
) -> np.ndarray:
    """``(C, *spatial)`` raw sample -> ``(D + 1, *spatial)`` float32
    embeddings. With ``transfer_precision = "float16"`` each tile batch's
    TTA output is rounded to float16 on the device before it is copied to
    the host (stored as float32), as the JAX package does."""
    if inference_config.spatial_shards >= 2:
        raise NotImplementedError(
            "spatial_shards >= 2 (a whole-sample sharded forward) is not ported yet "
            "(ROADMAP: M13, multi-GPU)"
        )
    device = torch.device(device)
    raw = np.asarray(raw)
    spatial = raw.shape[1:]
    geometry = compute_geometry(tuple(inference_config.crop_size), model.downsampling_factors)
    out_tile, context = geometry.output_size, geometry.context
    in_tile = tuple(o + 2 * c for o, c in zip(out_tile, context))
    nii = int(inference_config.num_infer_iterations)
    p = float(inference_config.p_salt_pepper)
    D = model.head[2].out_channels

    origins = list(itertools.product(
        *[tile_origins(max(s, o), o) for s, o in zip(spatial, out_tile)]
    ))
    gen = seeded_generator(device, inference_config.seed, sample_seed)
    tb = max(1, int(inference_config.tile_batch_size))
    transfer_dtype = (
        torch.float16 if inference_config.transfer_precision == "float16" else torch.float32
    )
    result = np.zeros((D + 1, *spatial), dtype=np.float32)

    def read(origin):
        region = read_reflect_region(
            lambda lo, hi: raw[(slice(None),) + tuple(slice(*b) for b in zip(lo, hi))],
            spatial, tuple(o - c for o, c in zip(origin, context)), in_tile,
        )
        return np.moveaxis(region * normalization_factor, 0, -1)

    def run_batch(host_tiles):
        tiles = torch.from_numpy(host_tiles).to(device)
        uniform = torch.rand(
            (2 * nii, *tiles.shape), generator=gen, device=device, dtype=torch.float32
        )
        with torch.no_grad():
            return tta_embeddings(model, tiles, uniform, p, nii, compute_dtype)

    for start in range(0, len(origins), tb):
        batch = origins[start : start + tb]
        host_tiles = np.stack([read(o) for o in batch]).astype(np.float32)
        # the upload and the forward; not the fetch below
        out = time_device("predict.device", run_batch, host_tiles)
        out = np.moveaxis(_fetch(out.to(transfer_dtype)).numpy(), -1, 1)  # (T, D + 1, *out_tile)
        for tile_out, origin in zip(out, batch):
            sel = tuple(slice(o, min(o + t, s)) for o, t, s in zip(origin, out_tile, spatial))
            crop = tuple(slice(0, sl.stop - sl.start) for sl in sel)
            result[(slice(None),) + sel] = tile_out[(slice(None),) + crop]
    return result


def predict(
    model: UNet,
    inference_config: InferenceConfig,
    normalization_factor,
    device,
    compute_dtype=torch.float32,
) -> None:
    """Predict stage: raw zarr -> embeddings zarr ``(s, D + 1, *spatial)``."""
    dataset_config = inference_config.dataset_config
    meta = DatasetMetaData.from_dataset_config(dataset_config)
    raw_ds = zarr.open(dataset_config.container_path, "r")[dataset_config.dataset_name]
    if normalization_factor is None:
        normalization_factor = normalization_factor_for(raw_ds.dtype)

    out_tile = compute_geometry(
        tuple(inference_config.crop_size), model.downsampling_factors
    ).output_size
    f = zarr.open(inference_config.prediction_dataset_config.container_path, "a")
    ds = f.create_dataset(
        inference_config.prediction_dataset_config.dataset_name,
        shape=(meta.num_samples, meta.num_spatial_dims + 1, *meta.spatial_array),
        dtype=np.float32,
        chunks=(1, meta.num_spatial_dims + 1, *out_tile),
        compressor=None,  # float embeddings do not compress
    )
    for sample in range(meta.num_samples):
        raw = np.asarray(raw_ds[sample], dtype=np.float32)
        ds[sample] = predict_sample(
            model, raw, inference_config, float(normalization_factor),
            sample, device, compute_dtype,
        )
    ds.attrs.update(spatial_attrs(meta))
