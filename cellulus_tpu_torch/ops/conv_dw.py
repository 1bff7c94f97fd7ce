"""Filter gradient of a VALID stride-1 3x3 conv (2D, channels-last).

    dw[ky, kx, ci, co] = sum_{b, y, x} x[b, y + ky, x + kx, ci] * g[b, y, x, co]

Replaces the TPU kernel ``cellulus_tpu/ops/pallas_dw.py:conv3x3_dw``. On a
CUDA tensor :func:`conv3x3_dw` launches the hand-written kernel
``csrc/conv_dw.cu`` (design and bound in its header); on a CPU tensor it
runs :func:`conv3x3_dw_plain`, nine float32 ``xs.T @ gs`` products, which
is also what the kernel is held against on the card. Both take float32 or
bfloat16 inputs as they are (no rounding of float32 inputs) and return
float32.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_SIGNATURES = {
    "conv3x3_dw_plan": ([ctypes.c_int] * 2, ctypes.c_int),
    "conv3x3_dw_splits": ([ctypes.c_int] * 5, ctypes.c_int),
    "conv3x3_dw_launch": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def _check(x: torch.Tensor, g: torch.Tensor):
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError(
            f"expected NHWC x (B, H, W, Ci) and g (B, H-2, W-2, Co), got "
            f"{tuple(x.shape)} and {tuple(g.shape)}"
        )
    B, H, W, Ci = x.shape
    if H < 3 or W < 3 or tuple(g.shape[:3]) != (B, H - 2, W - 2):
        raise ValueError(
            f"g must be (B, H-2, W-2, Co) for x {tuple(x.shape)}, got {tuple(g.shape)}"
        )
    if x.dtype != g.dtype or x.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"x and g must both be float32 or both bfloat16, got {x.dtype} and {g.dtype}"
        )
    if x.device != g.device:
        raise ValueError(f"x is on {x.device}, g on {g.device}")
    return B, H, W, Ci, int(g.shape[-1])


def conv3x3_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(3, 3, Ci, Co)`` float32, each tap one f32
    product of the shifted input's pixels with the cotangent's pixels."""
    B, H, W, Ci, Co = _check(x, g)
    Ho, Wo = H - 2, W - 2
    xf = x.float()
    gs = g.float().reshape(-1, Co)
    dw = torch.empty((3, 3, Ci, Co), dtype=torch.float32, device=x.device)
    for ky in range(3):
        for kx in range(3):
            xs = xf[:, ky : ky + Ho, kx : kx + Wo].reshape(-1, Ci)
            dw[ky, kx] = xs.T @ gs
    return dw


def conv3x3_dw_design(c_in: int, c_out: int, dtype: torch.dtype) -> str:
    """The plan the kernel takes for these channel counts (chosen by shape
    before launch, ``csrc/conv_dw.cu``): tensor cores or CUDA cores."""
    if not kernels.load("conv_dw", _SIGNATURES).conv3x3_dw_plan(c_in, c_out):
        return "CUDA cores (f32 FMA)"
    if dtype == torch.bfloat16:
        return "mma.sync m16n8k16 bf16"
    return "mma.sync m16n8k8 3xTF32"


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Filter gradient of a VALID 3x3 conv.

    Args:
        x: ``(B, H, W, Ci)`` primal input, float32 or bfloat16.
        g: ``(B, H-2, W-2, Co)`` output cotangent, same dtype as ``x``.

    Returns:
        ``(3, 3, Ci, Co)`` float32.
    """
    if x.device.type == "cpu":
        return conv3x3_dw_plain(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_dw runs on CUDA or CPU tensors, not {x.device}")
    B, H, W, Ci, Co = _check(x, g)
    out = torch.empty((3, 3, Ci, Co), dtype=torch.float32, device=x.device)
    if B * (H - 2) * (W - 2) == 0:
        return out.zero_()
    lib = kernels.load("conv_dw", _SIGNATURES)
    x = x.contiguous()
    g = g.contiguous()
    with torch.cuda.device(x.device):
        splits = lib.conv3x3_dw_splits(B, H, W, Ci, Co)
        ws = torch.empty((splits, 9 * Ci * Co), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv3x3_dw_launch(
            x.data_ptr(), g.data_ptr(), ws.data_ptr(), out.data_ptr(),
            B, H, W, Ci, Co, splits, _DTYPE_CODES[x.dtype], stream,
        )
    kernels.check_launch(rc, "conv3x3_dw")
    kernels.count_launch(conv3x3_dw)
    return out


conv3x3_dw.launches = 0
