"""A VALID stride-1 3x3 conv whose filter gradient is kernel K2.

Port of ``cellulus_tpu/ops/conv_vjp.py:conv_valid_pallas``: the forward and
the input gradient stay with the library (``F.conv2d`` and
``torch.nn.grad.conv2d_input``, cuDNN on the card; in JAX
``lax.conv_general_dilated`` and XLA's input gradient, outside any Pallas
kernel), and the filter gradient is
:func:`~cellulus_tpu_torch.ops.conv_dw.conv3x3_dw`: the hand-written kernel
on a CUDA tensor, its plain version on a CPU tensor. Activations are NHWC,
weights OIHW (``nn.Conv2d``'s layout), both in the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv_dw import conv3x3_dw


class Conv3x3Valid(torch.autograd.Function):
    """``(B, H, W, Ci), (Co, Ci, 3, 3) -> (B, H-2, W-2, Co)``, no bias."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return F.conv2d(x.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(
                x.permute(0, 3, 1, 2).shape, w, g.permute(0, 3, 1, 2)
            ).permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            # f32 (ky, kx, Ci, Co) -> OIHW, rounded to the weight's dtype
            # (JAX: ``.astype(w.dtype)``)
            dw = conv3x3_dw(x, g).permute(3, 2, 0, 1).to(w.dtype)
        return dx, dw


def conv3x3_valid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return Conv3x3Valid.apply(x, w)
