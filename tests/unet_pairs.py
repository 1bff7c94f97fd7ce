"""One seeded U-Net as the port's module and as the JAX package's params.

The port's ``init_unet_`` draws the weights and the JAX package's
``torch_state_dict_to_params`` imports them, so a test pays for no JAX
initializer compile per weight shape.
"""

from __future__ import annotations

import torch

from cellulus_tpu.models import UNetSpec
from cellulus_tpu.models.torch_import import torch_state_dict_to_params
from cellulus_tpu_torch.models import UNet, init_unet_


def unet_pair(ndim, factors, num_fmaps=8, inc=2, fil=16, constant_upsample=True, seed=0):
    """``(spec, params, model)`` holding the same Kaiming-normal weights."""
    factors = tuple(tuple(f) for f in factors)
    model = UNet(1, ndim, num_fmaps, inc, fil, [list(f) for f in factors], ndim,
                 constant_upsample=constant_upsample)
    init_unet_(model, "kaiming_normal", torch.Generator().manual_seed(seed))
    spec = UNetSpec(1, ndim, num_fmaps, inc, fil, factors, ndim,
                    constant_upsample=constant_upsample)
    return spec, torch_state_dict_to_params(model.state_dict()), model.eval()
