"""Fused [3,1,1,3] U-Net conv pass (2D, inference path).

It defines no gradient: both versions raise when a gradient would have to
flow through them (grad mode on and ``x`` or a weight requiring one).

One conv pass is conv3x3 -> ReLU -> conv1x1 -> ReLU -> conv1x1 -> ReLU ->
conv3x3 -> ReLU, all VALID, every stage with the pass's output width; f32
accumulation, and each intermediate stored in the compute dtype.

Replaces the TPU kernel ``cellulus_tpu/ops/pallas_conv.py:conv_pass_2d``.
On a CUDA tensor :func:`conv_pass_2d` launches the hand-written kernel
``csrc/conv_pass.cu`` (design and bound in its header); on a CPU tensor it
runs :func:`conv_pass_2d_plain`, four ``F.conv2d`` calls with the same
rounding points, which is also what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils import kernels

# dynamic shared memory one block may use on Hopper (227 KB)
MAX_SHARED_BYTES = 232448
TILE_CANDIDATES = (16, 12, 8, 6, 4, 2, 1)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_SIZES = (3, 1, 1, 3)

_SIGNATURES = {
    "conv_pass_2d_launch": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    "conv_pass_2d_smem_bytes": ([ctypes.c_int] * 5, ctypes.c_longlong),
}


def _checked_args(x, pass_params, compute_dtype):
    """Validate shapes and types; return ``(weights, biases)`` lists."""
    if torch.is_grad_enabled() and (
        x.requires_grad
        or any(t.requires_grad for conv in pass_params.values() for t in conv.values())
    ):
        raise RuntimeError(
            "conv_pass_2d is inference-only: it defines no gradient. Call it "
            "under torch.no_grad(), or use UNet's training path (per-conv "
            "autograd with the K2 filter gradient)"
        )
    if compute_dtype not in _DTYPE_CODES:
        raise ValueError(
            f"conv_pass_2d computes in float32 or bfloat16, not {compute_dtype}"
        )
    if x.dim() != 4:
        raise ValueError(f"expected NHWC input (B, H, W, C_in), got shape {tuple(x.shape)}")
    B, H, W, c_in = x.shape
    if H < 5 or W < 5:
        raise ValueError(f"input {H}x{W} too small for a [3,1,1,3] pass")
    weights, biases = [], []
    c_prev = c_in
    c_out = int(pass_params["conv0"]["w"].shape[-1])
    for i, k in enumerate(_KERNEL_SIZES):
        w = pass_params[f"conv{i}"]["w"]
        b = pass_params[f"conv{i}"]["b"]
        if tuple(w.shape) != (k, k, c_prev, c_out) or tuple(b.shape) != (c_out,):
            raise ValueError(
                f"conv{i}: expected w {(k, k, c_prev, c_out)} and b {(c_out,)}, "
                f"got {tuple(w.shape)} and {tuple(b.shape)}"
            )
        if w.device != x.device or b.device != x.device:
            raise ValueError(f"conv{i} parameters are not on {x.device}")
        weights.append(w)
        biases.append(b)
        c_prev = c_out
    return weights, biases


def conv_pass_2d_plain(
    x: torch.Tensor, pass_params: dict, compute_dtype=torch.float32
) -> torch.Tensor:
    """Plain PyTorch version: ``(B, H, W, C_in) -> (B, H-4, W-4, C)`` in
    ``compute_dtype``. Each stage convolves compute-dtype values in f32,
    adds the f32 bias, applies ReLU and rounds to the compute dtype."""
    weights, biases = _checked_args(x, pass_params, compute_dtype)
    y = x.to(compute_dtype).permute(0, 3, 1, 2).float()
    for w, b in zip(weights, biases):
        w = w.to(compute_dtype).float().permute(3, 2, 0, 1)  # (C, C_in, kh, kw)
        y = F.relu(F.conv2d(y, w, b.float())).to(compute_dtype).float()
    return y.to(compute_dtype).permute(0, 2, 3, 1).contiguous()


def _pick_tile(lib, c_in: int, c_out: int, elem_bytes: int) -> int:
    for tile in TILE_CANDIDATES:
        if lib.conv_pass_2d_smem_bytes(c_in, c_out, tile, tile, elem_bytes) <= MAX_SHARED_BYTES:
            return tile
    raise ValueError(
        f"conv pass {c_in}->{c_out} channels does not fit one block's shared memory"
    )


def conv_pass_2d(
    x: torch.Tensor, pass_params: dict, compute_dtype=torch.float32
) -> torch.Tensor:
    """Fused conv pass, channels-last.

    Args:
        x: ``(B, H, W, C_in)``.
        pass_params: ``{"conv0": {"w", "b"}, ..., "conv3": {...}}`` with
            ``w`` of shape ``(kh, kw, C_in, C_out)`` and ``b`` of ``(C_out,)``
            (the layout of the JAX package's params).
        compute_dtype: ``torch.float32`` or ``torch.bfloat16``.

    Returns:
        ``(B, H-4, W-4, C_out)`` in ``compute_dtype``.
    """
    if x.device.type == "cpu":
        return conv_pass_2d_plain(x, pass_params, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv_pass_2d runs on CUDA or CPU tensors, not {x.device}")
    weights, biases = _checked_args(x, pass_params, compute_dtype)
    lib = kernels.load("conv_pass", _SIGNATURES)
    B, H, W, c_in = x.shape
    c_out = weights[0].shape[-1]
    elem = torch.tensor([], dtype=compute_dtype).element_size()
    tile = _pick_tile(lib, c_in, c_out, elem)
    # repack once per call: compute-dtype weights (kh, kw, C_in, C_out), f32 biases
    x = x.to(compute_dtype).contiguous()
    ws = [w.to(compute_dtype).contiguous() for w in weights]
    bs = [b.float().contiguous() for b in biases]
    out = torch.empty((B, H - 4, W - 4, c_out), dtype=compute_dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = [x.data_ptr()]
        for w, b in zip(ws, bs):
            args += [w.data_ptr(), b.data_ptr()]
        rc = lib.conv_pass_2d_launch(
            *args, out.data_ptr(), B, H, W, c_in, c_out, tile, tile,
            _DTYPE_CODES[compute_dtype], stream,
        )
    kernels.check_launch(rc, "conv_pass_2d")
    conv_pass_2d.launches += 1
    return out


conv_pass_2d.launches = 0
