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

The kernel has two routes, chosen by shape before the launch
(:func:`conv_pass_2d_plan`): the fused pass, one launch with the
intermediates in shared memory, at the square tile that fits one block and
that the kernel's cost model rates cheapest; and, for a pass whose fused
plan fits no tile (the bottom pass of a 256-fmap model), the staged route,
one launch per stage with the intermediates in device memory in the
compute dtype. The plan is computed here from Python mirrors of the
source's size and cost formulas (``chip_smoke.py`` holds them against the
library's), so the CPU tests can check the route of every pass.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils import kernels

# dynamic shared memory one block may use on Hopper (227 KB)
MAX_SHARED_BYTES = 232448
TILE_CANDIDATES = (16, 14, 12, 8, 6, 4, 2, 1)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_SIZES = (3, 1, 1, 3)

# the staged route's output tile (one per stage)
STAGED_TILE = 16

_SIGNATURES = {
    "conv_pass_2d_launch": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    "conv_pass_2d_staged_launch": (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    "conv_pass_2d_smem_bytes": ([ctypes.c_int] * 5, ctypes.c_longlong),
    "conv_pass_2d_staged_smem_bytes": ([ctypes.c_int] * 5, ctypes.c_longlong),
    "conv_pass_2d_cost": ([ctypes.c_int] * 7, ctypes.c_longlong),
}

# csrc/conv_pass.cu's Cfg<T> by element bytes: the warp's unit (mt m16 x nt
# n8 tiles), ring stages, activation pitch padding, input channels a ring
# stage streams (scb) and the mma depth each tap's channels pad to
_CFG = {
    2: dict(mt=2, nt=8, stages=3, pad=8, scb=16, kpad=16),
    4: dict(mt=2, nt=4, stages=2, pad=4, scb=8, kpad=8),
}
_THREADS = 256


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _r16(c: int) -> int:
    return _ceil(c, 16) * 16


def _r8(n: int) -> int:
    return _ceil(n, 8) * 8


def _w_pitch(c: int) -> int:
    return _r16(c) + 8


def fused_smem_bytes(c_in: int, c: int, th: int, tw: int, elem: int) -> int:
    """Mirror of ``conv_pass_2d_smem_bytes``: the fused route's shared bytes
    a block at a ``th x tw`` output tile."""
    g = _CFG[elem]
    kc = 64 if c <= 64 else 32
    chunk = kc * _w_pitch(c)
    stream = c_in >= 128 and c_in % g["scb"] == 0
    if stream:
        sliced = _r8((th + 4) * (tw + 4) * (g["scb"] + g["pad"]))
        ring = max(sliced + 9 * g["scb"] * _w_pitch(c), chunk)
    else:
        ring = chunk
    mid = (th + 2) * (tw + 2) * (_r16(c) + g["pad"])
    inp = 0 if stream else (th + 4) * (tw + 4) * (_r16(c_in) + g["pad"])
    return (_r8(mid) + _r8(max(inp, mid)) + g["stages"] * ring) * elem


def fused_cost(c_in: int, c: int, th: int, tw: int, H: int, W: int, elem: int) -> int:
    """Mirror of ``conv_pass_2d_cost``: blocks x (rounds x K rows) over the
    four stages of the fused route."""
    g = _CFG[elem]
    um, un, kp = 16 * g["mt"], 8 * g["nt"], g["kpad"]
    n_n = _ceil(_r16(c), un)

    def rounds(P):
        return _ceil(_ceil(P, um) * n_n, _THREADS // 32)

    cinp, cp = _ceil(c_in, kp) * kp, _ceil(c, kp) * kp
    rows = rounds((th + 2) * (tw + 2)) * (9 * cinp + 2 * cp) + rounds(th * tw) * 9 * cp
    return _ceil(H - 4, th) * _ceil(W - 4, tw) * rows


def staged_smem_bytes(k: int, c_in: int, th: int, tw: int, elem: int) -> int:
    """Mirror of ``conv_pass_2d_staged_smem_bytes``: a block of the staged
    route at a ``k x k`` stage with ``c_in`` input channels."""
    g = _CFG[elem]
    sb = 4 * g["scb"] if k == 1 and c_in % (4 * g["scb"]) == 0 else g["scb"]
    nb = 8 * g["nt"]
    ring = _r8((th + k - 1) * (tw + k - 1) * (sb + g["pad"])) + k * k * sb * _w_pitch(nb)
    return g["stages"] * ring * elem


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


def conv_pass_2d_plan(shape, c_out: int, compute_dtype):
    """The route and square output tile an NHWC input of ``shape`` takes:
    ``("fused", t)``, the tile that fits one block and that the cost model
    rates cheapest (the larger one on a tie), or, when no tile fits,
    ``("staged", t)``, the largest staged tile whose four stages fit. Raise
    ``ValueError`` when neither route takes the shape."""
    elem = torch.tensor([], dtype=compute_dtype).element_size()
    _, H, W, c_in = shape
    fits = [t for t in TILE_CANDIDATES
            if fused_smem_bytes(c_in, c_out, t, t, elem) <= MAX_SHARED_BYTES]
    if fits:
        return "fused", min(fits, key=lambda t: fused_cost(c_in, c_out, t, t, H, W, elem))
    scb = _CFG[elem]["scb"]
    if c_in % scb == 0 and c_out % scb == 0:
        for t in (STAGED_TILE, *[c for c in TILE_CANDIDATES if c < STAGED_TILE]):
            if max(staged_smem_bytes(k, ci, t, t, elem)
                   for k, ci in ((3, c_in), (1, c_out), (3, c_out))) <= MAX_SHARED_BYTES:
                return "staged", t
    raise ValueError(
        f"conv pass {c_in}->{c_out} channels fits no fused tile, and the staged route "
        f"takes channels in multiples of {scb} only"
    )


def conv_pass_2d_design(shape, c_out: int, compute_dtype) -> str:
    """The kernel's design for an NHWC input of ``shape``: every stage on
    the tensor cores (``csrc/conv_pass.cu``), its route and output tile."""
    route, tile = conv_pass_2d_plan(shape, c_out, compute_dtype)
    mma = "mma.sync m16n8k16 bf16" if compute_dtype == torch.bfloat16 else "mma.sync m16n8k8 3xTF32"
    where = "fused" if route == "fused" else "staged, one launch a stage"
    return f"{mma}, {where}, {tile}x{tile} tile"


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
    B, H, W, c_in = x.shape
    c_out = weights[0].shape[-1]
    route, tile = conv_pass_2d_plan(x.shape, c_out, compute_dtype)
    lib = kernels.load("conv_pass", _SIGNATURES)
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
        if route == "fused":
            rc = lib.conv_pass_2d_launch(
                *args, out.data_ptr(), B, H, W, c_in, c_out, tile, tile,
                _DTYPE_CODES[compute_dtype], stream,
            )
        else:
            # the intermediates, (B, H-2, W-2, C) in the compute dtype each
            scratch = torch.empty((2, B, H - 2, W - 2, c_out), dtype=compute_dtype,
                                  device=x.device)
            rc = lib.conv_pass_2d_staged_launch(
                *args, out.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
                B, H, W, c_in, c_out, tile, tile, _DTYPE_CODES[compute_dtype], stream,
            )
    kernels.check_launch(rc, "conv_pass_2d")
    conv_pass_2d.launches += 1
    return out


conv_pass_2d.launches = 0
