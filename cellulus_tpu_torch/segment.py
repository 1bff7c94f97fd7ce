"""Segment stage, "cell" mode: detections -> post-processed instances.

Port of ``cellulus_tpu/segment.py`` (``cell_segment_sample``, ``segment``):
halo removal (grow by ``grow_distance``, then shrink by
``shrink_distance``) as disk convolutions on the device, then connected
components (full connectivity: 8 in 2D, 26 in 3D), the ``min_size``
filter and a consecutive relabel on the host.
With ``min_size == 0`` the halo-removed detections are kept as they are,
without relabelling, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs import InferenceConfig
from .io import DatasetMetaData, zarr
from .io.meta_data import spatial_attrs
from .ops.components import filter_relabel
from .ops.morphology import halo_removal


def cell_segment_sample(
    segmentation: np.ndarray,
    grow_distance: float,
    shrink_distance: float,
    min_size: int,
    device,
) -> np.ndarray:
    """Halo removal + size filter + relabel of one 2D or 3D label image."""
    if segmentation.dtype != np.uint16 and segmentation.size:
        lo, hi = segmentation.min(), segmentation.max()
        if lo < 0 or hi > np.iinfo(np.uint16).max:
            raise ValueError(
                f"cell_segment_sample needs uint16-range labels, got [{lo}, {hi}] "
                f"in dtype {segmentation.dtype}"
            )
    seg = torch.from_numpy(np.ascontiguousarray(segmentation, dtype=np.int32)).to(device)
    seg = halo_removal(seg, float(grow_distance), float(shrink_distance)).cpu().numpy()
    if min_size == 0:
        return seg.astype(segmentation.dtype)
    return filter_relabel(seg, int(min_size)).astype(segmentation.dtype)


def segment(inference_config: InferenceConfig, device) -> None:
    ic = inference_config
    if ic.post_processing != "cell":
        raise NotImplementedError(
            "post_processing='nucleus' is not ported yet (ROADMAP: M11, nucleus mode)"
        )
    meta = DatasetMetaData.from_dataset_config(ic.dataset_config)
    f = zarr.open(ic.segmentation_dataset_config.container_path, "a")
    ds_in = f[ic.segmentation_dataset_config.secondary_dataset_name]
    ds_out = f.create_dataset(
        ic.segmentation_dataset_config.dataset_name,
        shape=(meta.num_samples, ic.num_bandwidths, *meta.spatial_array),
        dtype=np.uint16,
    )
    ds_out.attrs.update(spatial_attrs(meta))
    for sample in range(meta.num_samples):
        for k in range(ic.num_bandwidths):
            ds_out[sample, k] = cell_segment_sample(
                np.asarray(ds_in[sample, k]),
                ic.grow_distance,
                ic.shrink_distance,
                ic.min_size,
                device,
            ).astype(np.uint16)
