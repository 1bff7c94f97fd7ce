"""The object-centric-embedding U-Net, its geometry and its weight bridge."""

from .convert import (
    adam_moments_from_jax,
    load_checkpoint,
    load_state_dict,
    state_dict_from_jax_params,
)
from .geometry import UNetGeometry, compute_geometry
from .unet import (
    UNet,
    init_unet_,
    select_and_add_coordinates,
    tta_embeddings,
    unet_from_config,
)

__all__ = [
    "UNet",
    "adam_moments_from_jax",
    "UNetGeometry",
    "compute_geometry",
    "init_unet_",
    "load_checkpoint",
    "load_state_dict",
    "select_and_add_coordinates",
    "state_dict_from_jax_params",
    "tta_embeddings",
    "unet_from_config",
]
