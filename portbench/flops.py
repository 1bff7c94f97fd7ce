"""The yardstick's arithmetic: operations and bytes from shapes, and the
card's published peaks.

Frozen copies, so that a change to the program cannot move them:

- :func:`model_flops` is the JAX package's ``models/unet.py:model_flops``
  (2 x MACs of every conv of one forward), rewritten in plain Python;
- :func:`conv_passes` is the port's ``models/geometry.py:conv_pass_inputs``
  (the conv passes of one forward, in order);
- :func:`k1_pass_cost` and :func:`k2_cost` are ``chip_smoke.py``'s operation
  and byte counts of K1 (the fused conv pass) and K2 (the 3x3 filter
  gradient): each input byte read once and each output byte written once.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

# NVIDIA H100 SXM, dense, at the 700 W limit (NVIDIA's data sheet)
PEAK_BF16 = 989e12
# TF32: the highest rate at which the card takes float32 inputs, so no
# float32-exact method can read above it
PEAK_TF32 = 495e12
# the 3xTF32 rate (three TF32 products a float32 product), the method K1
# and K2 use in float32; kept for reading beside the shares
PEAK_3XTF32 = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12
PASS_KERNELS = (3, 1, 1, 3)


def level_channels(model: dict, level: int) -> int:
    return model["num_fmaps"] * model["fmap_inc_factor"] ** level


def num_levels(model: dict) -> int:
    return len(model["downsampling_factors"]) + 1


def geometry(input_size: Sequence[int], factors) -> Tuple[list, tuple, list, tuple]:
    """``(skip sizes, bottom size, up sizes, output size)`` of a valid
    forward of ``input_size``: each pass shrinks every axis by 4, max-pool
    floors, nearest upsampling multiplies."""
    size = tuple(int(s) for s in input_size)
    skips = []
    for fac in factors:
        size = tuple(s - 4 for s in size)
        skips.append(size)
        size = tuple(s // f for s, f in zip(size, fac))
    size = tuple(s - 4 for s in size)
    bottom = size
    ups = []
    for level in reversed(range(len(factors))):
        size = tuple(s * f - 4 for s, f in zip(size, factors[level]))
        ups.append(size)
    if min(size) <= 0:
        raise ValueError(f"input {tuple(input_size)} too small for the U-Net")
    return skips, bottom, ups, size


def output_size(input_size, factors) -> tuple:
    return geometry(input_size, factors)[3]


def context(input_size, factors) -> tuple:
    out = output_size(input_size, factors)
    return tuple((i - o) // 2 for i, o in zip(input_size, out))


def conv_passes(model: dict, input_size: Sequence[int]) -> List[Tuple[str, tuple, int, int]]:
    """``(name, input spatial size, C_in, C_out)`` of every conv pass of one
    forward: ``down``, ``down1``, .., ``bottom``, then the up passes from the
    deepest to ``up``."""
    factors = [tuple(f) for f in model["downsampling_factors"]]
    skips, bottom, ups, _ = geometry(input_size, factors)
    chans = [level_channels(model, lv) for lv in range(len(factors) + 1)]
    passes = []
    size, c_prev = tuple(int(s) for s in input_size), model["in_channels"]
    for level, fac in enumerate(factors):
        passes.append((f"down{level or ''}", size, c_prev, chans[level]))
        c_prev = chans[level]
        size = tuple(s // f for s, f in zip(skips[level], fac))
    passes.append(("bottom", size, c_prev, chans[-1]))
    size = bottom
    for i, level in enumerate(reversed(range(len(factors)))):
        size = tuple(s * f for s, f in zip(size, factors[level]))
        c_out = model["features_in_last_layer"] if level == 0 else chans[level]
        passes.append((f"up{level or ''}", size, chans[level] + chans[level + 1], c_out))
        size = ups[i]
    return passes


def model_flops(model: dict, input_size: Sequence[int], out_channels: int) -> int:
    """Forward FLOPs of one input (2 x MACs of every conv)."""
    ndim = len(input_size)
    flops = 0

    def conv_pass(spatial, c_in, c_out):
        nonlocal flops
        for k in PASS_KERNELS:
            spatial = [s - (k - 1) for s in spatial]
            flops += 2 * math.prod(spatial) * k**ndim * c_in * c_out
            c_in = c_out
        return spatial

    factors = model["downsampling_factors"]
    x = list(input_size)
    c_prev = model["in_channels"]
    for level in range(num_levels(model) - 1):
        x = conv_pass(x, c_prev, level_channels(model, level))
        c_prev = level_channels(model, level)
        x = [s // f for s, f in zip(x, factors[level])]
    x = conv_pass(x, c_prev, level_channels(model, num_levels(model) - 1))
    for level in reversed(range(num_levels(model) - 1)):
        if not model.get("constant_upsample", True):
            c_up_t = level_channels(model, level + 1)
            flops += 2 * math.prod(x) * math.prod(factors[level]) * c_up_t * c_up_t
        x = [s * f for s, f in zip(x, factors[level])]
        c_out = model["features_in_last_layer"] if level == 0 else level_channels(model, level)
        x = conv_pass(x, level_channels(model, level) + level_channels(model, level + 1), c_out)
    fil = model["features_in_last_layer"]
    flops += 2 * math.prod(x) * fil * fil
    flops += 2 * math.prod(x) * fil * out_channels
    return flops


def k1_pass_cost(B: int, H: int, W: int, c_in: int, c: int, elem: int) -> Tuple[int, int]:
    """``(flops, bytes)`` of one fused conv pass [3, 1, 1, 3] of an NHWC
    ``(B, H, W, c_in)`` input to ``c`` channels in a type of ``elem`` bytes:
    the input and output once, the four weights, four f32 biases."""
    flops = (2 * B * (H - 2) * (W - 2) * 9 * c_in * c
             + 2 * 2 * B * (H - 2) * (W - 2) * c * c
             + 2 * B * (H - 4) * (W - 4) * 9 * c * c)
    weights = 9 * c_in * c + 2 * c * c + 9 * c * c
    nbytes = elem * (B * H * W * c_in + B * (H - 4) * (W - 4) * c) + elem * weights + 4 * 4 * c
    return flops, nbytes


def k2_shapes(model: dict, batch: int, crop: Sequence[int]):
    """``(x shape, g shape)`` NHWC of every 3x3 filter gradient of a train
    step: the first and the last conv of each pass."""
    shapes = []
    for _, (H, W), c_in, c in conv_passes(model, crop):
        shapes.append(((batch, H, W, c_in), (batch, H - 2, W - 2, c)))
        shapes.append(((batch, H - 2, W - 2, c), (batch, H - 4, W - 4, c)))
    return shapes


def k2_cost(xs, gs, elem: int) -> Tuple[int, int]:
    """``(flops, bytes)`` of one filter gradient: x and g read once, the f32
    filter gradient written once."""
    B, H, W, c_in = xs
    c_out = gs[-1]
    flops = 2 * B * (H - 2) * (W - 2) * 9 * c_in * c_out
    nbytes = elem * (math.prod(xs) + math.prod(gs)) + 4 * 9 * c_in * c_out
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, peak: float) -> float:
    """The roofline's least time: the larger of operations over the peak and
    bytes over the HBM bandwidth."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)
