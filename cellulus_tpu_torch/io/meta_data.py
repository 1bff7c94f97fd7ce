"""Dataset axis-layout metadata.

Parses the ``axis_names`` attribute of a zarr dataset into a dimension
layout (reference parity: ``cellulus/datasets/meta_data.py:9-90``). The
expected layout is ``(s, c, [t,] [z,] y, x)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..configs import DatasetConfig
from . import zarr

_LAYOUT_HELP = (
    "The raw dataset should have shape (s, c, [t,] [z,] y, x), where "
    "s = # of samples, c = # of channels, t = # of frames, and z/y/x are "
    "spatial extents. The dataset should have an 'axis_names' attribute "
    "listing the axes, e.g. ['s', 'c', 'y', 'x'] for a 2D dataset."
)


class DatasetMetaData:
    """Axis layout of a ``(s, c, [t,] [z,] y, x)`` dataset."""

    def __init__(self, shape: Tuple[int, ...], axis_names):
        self.axis_names = list(axis_names)
        self.num_dims = len(self.axis_names)
        self.num_spatial_dims = 0
        self.num_samples = 0
        self.num_channels = 0
        self.sample_dim: Optional[int] = None
        self.channel_dim: Optional[int] = None
        self.time_dim: Optional[int] = None
        self.spatial_array: Tuple[int, ...] = ()

        for dim, name in enumerate(self.axis_names):
            if name == "s":
                self.sample_dim = dim
                self.num_samples = shape[dim]
            elif name == "c":
                self.channel_dim = dim
                self.num_channels = shape[dim]
            elif name == "t":
                # time is a full spatial-like axis: it counts toward
                # num_spatial_dims AND contributes its extent, so movies
                # train/infer as (t, y, x) pseudo-3D volumes. The reference
                # counts t as spatial but DROPS its extent from
                # spatial_array (reference meta_data.py:25-27), leaving
                # crop/model dimensionality inconsistent — a deliberate
                # divergence, documented in docs/configuration.md.
                self.num_spatial_dims += 1
                self.time_dim = dim
                self.spatial_array += (shape[dim],)
            elif name in ("z", "y", "x"):
                self.num_spatial_dims += 1
                self.spatial_array += (shape[dim],)

        if self.sample_dim is None:
            raise RuntimeError("dataset has no sample dimension\n\n" + _LAYOUT_HELP)
        if self.channel_dim is None:
            raise RuntimeError("dataset has no channel dimension\n\n" + _LAYOUT_HELP)
        if self.num_dims != len(shape):
            raise RuntimeError(
                f"dataset has {len(shape)} dimensions but axis_names has "
                f"{self.num_dims} entries\n\n" + _LAYOUT_HELP
            )

    @staticmethod
    def from_dataset_config(dataset_config: DatasetConfig) -> "DatasetMetaData":
        container = zarr.open(dataset_config.container_path, "r")
        try:
            data = container[dataset_config.dataset_name]
        except KeyError:
            raise RuntimeError(
                f"zarr container {dataset_config.container_path} has no "
                f"'{dataset_config.dataset_name}' dataset\n\n" + _LAYOUT_HELP
            )
        axis_names = data.attrs.get("axis_names")
        if axis_names is None:
            raise RuntimeError(
                f"'{dataset_config.dataset_name}' in "
                f"{dataset_config.container_path} has no 'axis_names' "
                "attribute\n\n" + _LAYOUT_HELP
            )
        return DatasetMetaData(data.shape, axis_names)


def spatial_attrs(meta: "DatasetMetaData") -> dict:
    """Output-dataset attrs ``(axis_names, resolution, offset)`` for arrays
    shaped ``(s, c, *spatial)`` derived from ``meta``'s dataset.

    Carries the INPUT's spatial axis names through (a movie's ``t`` axis
    must not come out relabeled ``z``); falls back to z/y/x naming when the
    input metadata lacks usable names. Shared by every pipeline stage that
    writes zarr outputs.
    """
    spatial = [n for n in getattr(meta, "axis_names", []) if n not in ("s", "c")]
    if len(spatial) != meta.num_spatial_dims:
        spatial = ["t", "z", "y", "x"][-meta.num_spatial_dims:]
    return {
        "axis_names": ["s", "c"] + spatial,
        "resolution": [1] * meta.num_spatial_dims,
        "offset": [0] * meta.num_spatial_dims,
    }
