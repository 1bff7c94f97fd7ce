"""Filter gradient of a VALID stride-1 3x3 conv (2D, channels-last).

    dw[ky, kx, ci, co] = sum_{b, y, x} x[b, y + ky, x + kx, ci] * g[b, y, x, co]

Replaces the TPU kernel ``cellulus_tpu/ops/pallas_dw.py:conv3x3_dw``. On a
CUDA tensor :func:`conv3x3_dw` launches the hand-written kernel
``csrc/conv_dw.cu`` (design and bound in its header); on a CPU tensor it
runs :func:`conv3x3_dw_plain`, nine float32 ``xs.T @ gs`` products, which
is also what the kernel is held against on the card. Both take float32 or
bfloat16 inputs as they are (no rounding of float32 inputs) and return
float32.

The plan functions below mirror the source's formulas (between its "K2
plan begin" and "K2 plan end" markers): the route, the chunk, the shared
memory and the pixel splits. The CPU tests hold them against a g++ build of
those lines and emulate the kernel's data path with them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..utils import kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_SIGNATURES = {
    "conv3x3_dw_plan": ([ctypes.c_int] * 3, ctypes.c_int),
    "conv3x3_dw_smem_bytes": ([ctypes.c_int] * 2, ctypes.c_longlong),
    "conv3x3_dw_splits": ([ctypes.c_int] * 6, ctypes.c_int),
    "conv3x3_dw_launch": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
}

# Mirrors of csrc/conv_dw.cu's plan (kCi, kBarBytes, kAlign, kMaxStages,
# kMaxSmem, Dw<2>, Dw<4>)
CI_BLOCK = 64
BAR_BYTES = 128
ALIGN = 1024
MAX_STAGES = 8
MAX_SMEM = 232448


@dataclass(frozen=True)
class Chunking:
    """Per element size: pixels per k step (ks), output channels of a block
    (nb: 128 bytes of a pixel), chunk rows and pixels (ty, tx), and the taps
    route's buffers of A rows (nbuf)."""

    ks: int
    nb: int
    ty: int
    tx: int
    nbuf: int


CHUNKING = {2: Chunking(16, 64, 16, 16, 4), 4: Chunking(8, 32, 8, 16, 3)}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sw128(p, b):
    """Byte ``b`` (0..127) of row ``p`` of a tile of 128-byte rows as TMA's
    128-byte swizzle lays it out from a 1024-byte aligned base (numpy
    arrays welcome)."""
    return p * 128 + ((((b >> 4) ^ p) & 7) << 4) + (b & 15)


def fold(c_in: int) -> bool:
    """Route 2: (tap, ci) folded into one m64 tile of wgmma's M."""
    return 9 * c_in <= 64


def tma_ok(c: int, elem: int) -> bool:
    """TMA boxes need 16-byte strides."""
    return c * elem % 16 == 0


def layout(elem: int, folded: bool) -> dict:
    """Shared memory of a block of the route (``dw_layout``), from a
    1024-byte aligned base: bytes of an x box (128-byte rows), the x area
    (route 2: the dense tile of at most 7 channels), the g tile, a stage, an
    f32 slab; the stages; the offsets of the slabs and of the barriers; the
    total with the base's alignment."""
    c = CHUNKING[elem]
    xbox = _cdiv(128 * (c.ty + 2) * (c.tx + 2), 1024) * 1024
    xbytes = (_cdiv((c.ty + 2) * (c.tx + 2) * 7 * elem, 1024) * 1024 if folded
              else CI_BLOCK * elem // 128 * xbox)
    gbytes = c.ty * c.tx * c.nb * elem
    stage = xbytes + gbytes
    slab = c.ty * c.tx * c.nb * 4 if elem == 4 else 0
    stages = min(MAX_STAGES, (MAX_SMEM - ALIGN - BAR_BYTES - 4 * slab) // stage)
    slabs = stages * stage
    bars = slabs + 4 * slab
    return dict(xbox=xbox, xbytes=xbytes, gbytes=gbytes, stage=stage, slab=slab, stages=stages,
                slabs=slabs, bars=bars, total=bars + BAR_BYTES + ALIGN)


def grid(B: int, H: int, W: int, c_in: int, c_out: int, elem: int) -> dict:
    """The launch's tiles and chunks (``dw_grid``)."""
    c = CHUNKING[elem]
    f = fold(c_in)
    chunks_y, chunks_x = _cdiv(H - 2, c.ty), _cdiv(W - 2, c.tx)
    return dict(fold=f, n_ci_blocks=1 if f else _cdiv(c_in, CI_BLOCK),
                n_co_blocks=_cdiv(c_out, c.nb), chunks_y=chunks_y, chunks_x=chunks_x,
                n_chunks=B * chunks_y * chunks_x)


def splits(B: int, H: int, W: int, c_in: int, c_out: int, elem: int, sms: int) -> int:
    """Pixel splits (``dw_splits``): one wave over ``sms`` SMs, none empty."""
    gr = grid(B, H, W, c_in, c_out, elem)
    tiles = gr["n_ci_blocks"] * gr["n_co_blocks"]
    s = max(1, min(sms // tiles, gr["n_chunks"]))
    return _cdiv(gr["n_chunks"], _cdiv(gr["n_chunks"], s))


def split_chunks(B: int, H: int, W: int, c_in: int, c_out: int, elem: int, n_splits: int):
    """Each split's chunk range ``[begin, end)``, as the kernel reads it from
    ``per_split = ceil(chunks / splits)``."""
    n = grid(B, H, W, c_in, c_out, elem)["n_chunks"]
    per = _cdiv(n, n_splits)
    return [(s * per, min(n, (s + 1) * per)) for s in range(n_splits)]


def chunk_origin(c: int, chunks_y: int, chunks_x: int, elem: int):
    """Chunk c's image and output origin ``(b, y0, x0)`` (``dw_chunk``)."""
    k = CHUNKING[elem]
    b, rem = divmod(c, chunks_y * chunks_x)
    return b, rem // chunks_x * k.ty, rem % chunks_x * k.tx


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


def conv3x3_dw_plan(c_in: int, c_out: int, elem: int) -> int:
    """The mirror of the source's ``conv3x3_dw_plan``: bit 0 route 2
    (folded), bit 1 x by TMA, bit 2 g by TMA (for 16-byte aligned tensors)."""
    f = fold(c_in)
    return int(f) | int(not f and tma_ok(c_in, elem)) << 1 | int(tma_ok(c_out, elem)) << 2


def conv3x3_dw_design(c_in: int, c_out: int, dtype: torch.dtype) -> str:
    """The design the kernel takes for these channel counts (chosen by shape
    before launch, ``csrc/conv_dw.cu``): the route, the wgmma and how each
    tile arrives (TMA boxes, or element copies where TMA cannot stride)."""
    elem = dtype.itemsize
    plan = conv3x3_dw_plan(c_in, c_out, elem)
    c = CHUNKING[elem]
    mma = f"wgmma m64n{c.nb}k16 bf16" if elem == 2 else f"wgmma m64n{c.nb}k8 3xTF32"
    route = "(tap, ci) folded into M" if plan & 1 else "taps: 64 ci x 3 taps a warpgroup"
    feed = (f"x {'TMA' if plan & 2 else 'element copies'}, "
            f"g {'TMA' if plan & 4 else 'element copies'}")
    return f"{mma}, {route}; {feed}"


# pixel splits by (device, shape, element size): counts only, no addresses
_SPLITS: dict = {}


def _launch(lib, x, g, out, B, H, W, Ci, Co) -> int:
    """The kernel and its split reduction on the current device and stream;
    the workspace from ``torch.empty``. Returns the CUDA error code."""
    key = (x.device.index, B, H, W, Ci, Co, x.element_size())
    n_splits = _SPLITS.get(key)
    if n_splits is None:
        n_splits = _SPLITS[key] = lib.conv3x3_dw_splits(B, H, W, Ci, Co, x.element_size())
    ws = torch.empty((n_splits, 9 * Ci * Co), dtype=torch.float32, device=x.device)
    return lib.conv3x3_dw_launch(
        x.data_ptr(), g.data_ptr(), ws.data_ptr(), out.data_ptr(),
        B, H, W, Ci, Co, n_splits, _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )


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
    if x.device.index == torch.cuda.current_device():
        rc = _launch(lib, x, g, out, B, H, W, Ci, Co)
    else:
        with torch.cuda.device(x.device):
            rc = _launch(lib, x, g, out, B, H, W, Ci, Co)
    kernels.check_launch(rc, "conv3x3_dw")
    kernels.count_launch(conv3x3_dw)
    return out


conv3x3_dw.launches = 0
