"""The object-centric-embedding U-Net in plain PyTorch, 2D and 3D.

The reference's architecture (funlib's UNet as cellulus builds it,
``cellulus/models/unet.py``): per level a valid conv pass of kernels
[3, 1, 1, 3], each conv followed by ReLU; max-pool on the way down; nearest
upsampling on the way up (``constant_upsample=True``), the skip centre
cropped to the upsampled size and concatenated before it ``[skip, up]``,
then a conv pass; the head is 1x1 -> ReLU -> 1x1 with no final activation.
Channels first, ``F.conv2d`` / ``F.conv3d`` in float32 with TF32 off.

Parameters are named as funlib names them (``backbone.l_conv.<l>.conv_pass.<2i>``,
``backbone.r_conv.0.<l>.conv_pass.<2i>``, ``head.<0|2>``).

``quantize``, when given, is applied to the input and the weight of every
conv before it runs: the lower-precision control of the benchmark's check.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

PASS_KERNELS = (3, 1, 1, 3)


def _level_channels(model: dict, level: int) -> int:
    return model["num_fmaps"] * model["fmap_inc_factor"] ** level


def param_shapes(model: dict, ndim: int) -> List[Tuple[str, tuple]]:
    """``(name, shape)`` of every weight and bias, in a fixed order."""
    levels = len(model["downsampling_factors"]) + 1
    chans = [_level_channels(model, lv) for lv in range(levels)]
    out = []

    def conv_pass(prefix, c_in, c_out):
        for i, k in enumerate(PASS_KERNELS):
            out.append((f"{prefix}.conv_pass.{2 * i}.weight", (c_out, c_in) + (k,) * ndim))
            out.append((f"{prefix}.conv_pass.{2 * i}.bias", (c_out,)))
            c_in = c_out

    c_prev = model["in_channels"]
    for level in range(levels):
        conv_pass(f"backbone.l_conv.{level}", c_prev, chans[level])
        c_prev = chans[level]
    for level in range(levels - 1):
        c_out = model["features_in_last_layer"] if level == 0 else chans[level]
        conv_pass(f"backbone.r_conv.0.{level}", chans[level] + chans[level + 1], c_out)
    fil = model["features_in_last_layer"]
    out.append(("head.0.weight", (fil, fil) + (1,) * ndim))
    out.append(("head.0.bias", (fil,)))
    out.append(("head.2.weight", (ndim, fil) + (1,) * ndim))
    out.append(("head.2.bias", (ndim,)))
    return out


def forward(params: Dict[str, torch.Tensor], model: dict, x: torch.Tensor,
            quantize: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """``(B, C_in, *spatial) -> (B, D, *spatial_out)`` float32 offsets."""
    ndim = x.dim() - 2
    conv = F.conv2d if ndim == 2 else F.conv3d
    pool = F.max_pool2d if ndim == 2 else F.max_pool3d
    q = quantize or (lambda t: t)
    factors = [tuple(f) for f in model["downsampling_factors"]]
    levels = len(factors) + 1

    def conv_pass(prefix, x):
        for i in range(len(PASS_KERNELS)):
            w = params[f"{prefix}.conv_pass.{2 * i}.weight"]
            b = params[f"{prefix}.conv_pass.{2 * i}.bias"]
            x = torch.relu(conv(q(x), q(w), b))
        return x

    skips = []
    for level in range(levels - 1):
        x = conv_pass(f"backbone.l_conv.{level}", x)
        skips.append(x)
        x = pool(x, factors[level], factors[level])
    x = conv_pass(f"backbone.l_conv.{levels - 1}", x)
    for level in reversed(range(levels - 1)):
        for axis, f in enumerate(factors[level]):
            x = x.repeat_interleave(f, dim=2 + axis)
        skip = skips[level]
        crop = tuple(slice((s - t) // 2, (s - t) // 2 + t)
                     for s, t in zip(skip.shape[2:], x.shape[2:]))
        x = torch.cat([skip[(slice(None), slice(None)) + crop], x], dim=1)
        x = conv_pass(f"backbone.r_conv.0.{level}", x)
    x = torch.relu(conv(q(x), q(params["head.0.weight"]), params["head.0.bias"]))
    return conv(q(x), q(params["head.2.weight"]), params["head.2.bias"])


def fp8_quantize(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale a tensor (its largest magnitude
    to the type's largest finite value), back in float32: a conv then sees
    fp8 inputs and accumulates in float32."""
    amax = t.detach().abs().max().clamp(min=1e-12)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def no_tf32():
    """Turn TF32 off for float32 matmuls and convolutions; return a function
    that restores the previous settings."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def restore():
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    return restore
