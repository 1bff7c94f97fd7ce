"""Host-side streaming data pipeline (a copy of the JAX package's, numpy
and scipy only), and the torch device pair sampler."""

from typing import Optional, Tuple

from ..configs import DatasetConfig
from .sampling import PairSampler, disk_offsets
from .zarr_dataset import (
    BatchLoader,
    ConcatDataset,
    ZarrDataset,
    normalization_factor_for,
)


def get_dataset(
    dataset_config: DatasetConfig,
    crop_size: Tuple[int, ...],
    elastic_deform: bool,
    control_point_spacing: int,
    control_point_jitter: float,
    density: float,
    kappa: float,
    normalization_factor: Optional[float],
    output_shape: Optional[Tuple[int, ...]] = None,
    seed: int = 0,
    sample_pairs: bool = True,
    normalize: bool = True,
    pair_count_mode: str = "reference",
    elastic_device: bool = False,
) -> ZarrDataset:
    """Reference-parity factory (reference ``datasets/__init__.py:8-27``)."""
    return ZarrDataset(
        dataset_config=dataset_config,
        crop_size=crop_size,
        elastic_deform=elastic_deform,
        control_point_spacing=control_point_spacing,
        control_point_jitter=control_point_jitter,
        density=density,
        kappa=kappa,
        normalization_factor=normalization_factor,
        output_shape=output_shape,
        seed=seed,
        sample_pairs=sample_pairs,
        normalize=normalize,
        pair_count_mode=pair_count_mode,
        elastic_device=elastic_device,
    )


__all__ = [
    "BatchLoader",
    "ConcatDataset",
    "PairSampler",
    "ZarrDataset",
    "disk_offsets",
    "get_dataset",
    "normalization_factor_for",
]
