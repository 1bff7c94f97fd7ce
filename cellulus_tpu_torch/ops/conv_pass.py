"""Fused [3,1,1,3] U-Net conv pass (2D, inference path).

It defines no gradient: both versions raise when a gradient would have to
flow through them (grad mode on and ``x`` or a weight requiring one).

One conv pass is conv3x3 -> ReLU -> conv1x1 -> ReLU -> conv1x1 -> ReLU ->
conv3x3 -> ReLU, all VALID, every stage with the pass's output width; f32
accumulation, and each intermediate stored in the compute dtype.

Replaces the TPU kernel ``cellulus_tpu/ops/pallas_conv.py:conv_pass_2d``.
:func:`conv_pass_2d` checks its arguments (and refuses under autograd), then
calls the custom op ``cellulus_tpu_torch::conv_pass_2d`` (``torch.library``,
so that ``torch.export`` keeps a pass as one node). On a CUDA tensor the op
launches the hand-written kernel ``csrc/conv_pass.cu`` (design and bound in
its header) and counts the launch; on a CPU tensor it runs the plain
version, four ``F.conv2d`` calls with the same rounding points
(:func:`conv_pass_2d_plain`), which is also what the kernel is held against
on the card.

The kernel has two routes, chosen by shape before the launch
(:func:`conv_pass_2d_plan`): the fused pass, one launch with the
intermediates in shared memory, at the square tile of at least
``FUSED_MIN_TILE`` that fits one block and that the kernel's cost model
rates cheapest; and, for a pass where no such tile fits (the bottom pass of
a 256-fmap model), the staged route, one launch per stage with the
intermediates in device memory in the compute dtype. The plan is computed
here from Python mirrors of the source's size and cost formulas
(``chip_smoke.py`` holds them against the library's), so the CPU tests can
check the route of every pass. Before each launch the wrapper packs the
weights into the layout the kernel's ``wgmma`` reads from its ring
(:func:`pack_stage`; float32 as tf32 hi and lo arrays), which the CPU
tests check too.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils import kernels

# dynamic shared memory one block may use on Hopper (227 KB)
MAX_SHARED_BYTES = 232448
TILE_CANDIDATES = (24, 20, 16, 14, 12, 10, 8, 6, 4, 2, 1)
# the fused route takes a tile below this only where the staged route cannot
# take the pass (a block of fewer pixels leaves a consumer warpgroup idle)
FUSED_MIN_TILE = 8
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

# csrc/conv_pass.cu's Cfg<T> by element bytes: K rows per wgmma (kstep),
# m64 tiles per consumer warpgroup (mt), K rows of a plain ring chunk (kc)
# and weight arrays (bf16 one; f32 hi and lo)
_CFG = {
    2: dict(kstep=16, mt=4, kc=128, arrays=1),
    4: dict(kstep=8, mt=1, kc=32, arrays=2),
}
NB = 64  # wgmma N: the columns of one n-block
_MAX_SLOTS = 4
_BAR_BYTES = 128


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _r128(n: int) -> int:
    return _ceil(n, 128) * 128


def _kin(elem: int) -> int:
    """Elements per 16 bytes."""
    return 16 // elem


def cin_pad(c: int, elem: int) -> int:
    """Channels padded to 16 bytes (the K order's channels per tap)."""
    return _ceil(c, _kin(elem)) * _kin(elem)


def _pitch(c: int, elem: int) -> int:
    """Pixel pitch of an activation tile: an odd number of 16-byte units."""
    return (_ceil(c, _kin(elem)) | 1) * _kin(elem)


def stream_sb(k: int, c_in: int, elem: int) -> int:
    """Input channels of one streamed chunk of a ``k x k`` stage."""
    ks = _CFG[elem]["kstep"]
    if k == 3:
        return 2 * ks if c_in % (2 * ks) == 0 else ks
    return next((m * ks for m in (4, 2) if c_in % (m * ks) == 0), ks)


def fused_streams(c_in: int, elem: int) -> bool:
    """Whether the fused route streams stage 1's input through the ring."""
    return c_in >= 128 and c_in % _CFG[elem]["kstep"] == 0


def stage_geometry(k: int, c_in: int, oh: int, ow: int, elem: int, sb: int = 0,
                   n_nb: int = 1) -> dict:
    """Mirror of ``make_stage``: how one stage walks the ring. ``krows`` K
    rows per n-block in ``n_chunks`` chunks of ``kc`` rows (the last one
    shorter where the rows run out), each ``chunk_bytes`` of weights per
    array; a streamed stage (``sb`` > 0) also carries an input slice of
    ``slice`` bytes (128-aligned) at the start of its slot. ``pair``: the
    two consumer warpgroups take the same m64 tiles and an n-block each (at
    most ``mt`` tiles, ``n_nb`` >= 2 n-blocks, where rounds x (tiles a
    warpgroup + 1) is lower so), and a slot holds a chunk of two n-blocks."""
    g = _CFG[elem]
    if sb:
        krows, kc, n_chunks = k * k * c_in, k * sb, c_in // sb * k
        slice_bytes = _r128(oh * (ow + k - 1) * sb * elem)
    else:
        krows = _ceil(k * k * cin_pad(c_in, elem), g["kstep"]) * g["kstep"]
        kc = g["kc"]
        n_chunks, slice_bytes = _ceil(krows, kc), 0
    n_mt = _ceil(oh * ow, 64)
    pair = (not sb and n_nb >= 2 and n_mt <= g["mt"]
            and _ceil(n_nb, 2) * (n_mt + 1) < n_nb * (_ceil(n_mt, 2) + 1))
    rows = [min(kc, krows - c * kc) for c in range(n_chunks)]
    return dict(k=k, sb=sb, krows=krows, kc=kc, n_chunks=n_chunks, slice=slice_bytes,
                oh=oh, ow=ow, n_nb=n_nb, pair=pair, chunk_bytes=[r * NB * elem for r in rows],
                slot_need=slice_bytes + kc * NB * elem * g["arrays"] * (2 if pair else 1))


def fused_stages(c_in: int, c: int, th: int, tw: int, elem: int) -> list:
    """Mirror of ``fused_stage``: the fused route's four stages."""
    first = stream_sb(3, c_in, elem) if fused_streams(c_in, elem) else 0
    n = _ceil(c, NB)
    return [stage_geometry(3, c_in, th + 2, tw + 2, elem, first, n),
            stage_geometry(1, c, th + 2, tw + 2, elem, 0, n),
            stage_geometry(1, c, th + 2, tw + 2, elem, 0, n),
            stage_geometry(3, c, th, tw, elem, 0, n)]


def _smem_total(ring: int, slot: int) -> int:
    """Mirror of ``finish_layout``: the bytes up to the ring, then 2..4 slots."""
    slot = _r128(slot)
    return ring + max(2, min(_MAX_SLOTS, (MAX_SHARED_BYTES - ring) // slot)) * slot


def fused_smem_bytes(c_in: int, c: int, th: int, tw: int, elem: int) -> int:
    """Mirror of ``conv_pass_2d_smem_bytes``: the fused route's shared bytes
    a block at a ``th x tw`` output tile (barriers, the intermediate buffer,
    the input buffer unless streamed, the ring)."""
    mid = _r128((th + 2) * (tw + 2) * _pitch(c, elem) * elem)
    inp = 0 if fused_streams(c_in, elem) else _r128(
        (th + 4) * (tw + 4) * _pitch(c_in, elem) * elem)
    slot = max(s["slot_need"] for s in fused_stages(c_in, c, th, tw, elem))
    return _smem_total(_BAR_BYTES + mid + max(inp, mid), slot)


def fused_cost(c_in: int, c: int, th: int, tw: int, H: int, W: int, elem: int) -> int:
    """Mirror of ``conv_pass_2d_cost``: blocks x the k steps of the busier
    consumer warpgroup over the stages and rounds (a round charged one m64
    tile more for its fill and epilogue)."""
    g = _CFG[elem]
    per_block = 0
    for s in fused_stages(c_in, c, th, tw, elem):
        n_mt = _ceil(s["oh"] * s["ow"], 64)
        if s["pair"]:
            outer, r, per_wg = _ceil(s["n_nb"], 2), 1, n_mt
        else:
            outer, r = s["n_nb"], _ceil(n_mt, 2 * g["mt"])
            per_wg = _ceil(n_mt, 2 * r)
        per_block += outer * r * (per_wg + 1) * (s["krows"] // g["kstep"])
    return _ceil(H - 4, th) * _ceil(W - 4, tw) * per_block


def staged_smem_bytes(k: int, c_in: int, th: int, tw: int, elem: int) -> int:
    """Mirror of ``conv_pass_2d_staged_smem_bytes``: a block of the staged
    route at a ``k x k`` stage with ``c_in`` input channels (barriers, its
    output tile's staging area, the ring)."""
    s = stage_geometry(k, c_in, th, tw, elem, stream_sb(k, c_in, elem))
    return _smem_total(_BAR_BYTES + _r128(th * tw * _pitch(NB, elem) * elem), s["slot_need"])


def _tf32_hi(w: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest tf32, ties away from zero, on the bit
    pattern: ``(bits + 0x1000) & 0xFFFFE000`` (the kernel's ``to_tf32``)."""
    bits = w.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = (bits + 0x1000) & 0xFFFFE000
    return torch.where(hi >= 2**31, hi - 2**32, hi).to(torch.int32).view(torch.float32)


def pack_stage(w: torch.Tensor, sb: int = 0) -> torch.Tensor:
    """One stage's weights ``(k, k, c_in, c)`` in the compute dtype, packed
    into the layout K1's wgmma reads from its ring: per n-block of 64
    columns, the K rows in 16-byte slabs, ``(n_nb, krows / kin, 64, kin)``
    (K-major, no swizzle). K is ordered (tap, channel) with the channels
    zero-padded to 16 bytes and the rows to the wgmma depth, or, streamed
    (``sb`` > 0), (channel block of ``sb``, tap, channel). Columns past
    ``c`` are zeros. float32 gives ``(2, ...)``: hi = tf32(w) and lo = w - hi."""
    k, _, c_in, c = w.shape
    elem = w.element_size()
    kin, n_nb = _kin(elem), _ceil(c, NB)
    krows = stage_geometry(k, c_in, 1, 1, elem, sb)["krows"]
    if sb:
        rows = w.reshape(k * k, c_in // sb, sb, c).permute(1, 0, 2, 3).reshape(-1, c)
    else:
        cp = cin_pad(c_in, elem)
        rows = F.pad(w.reshape(k * k, c_in, c), (0, 0, 0, cp - c_in)).reshape(-1, c)
    rows = F.pad(rows, (0, n_nb * NB - c, 0, krows - rows.shape[0]))
    packed = rows.reshape(krows // kin, kin, n_nb, NB).permute(2, 0, 3, 1).contiguous()
    if elem == 4:
        hi = _tf32_hi(packed)
        packed = torch.stack((hi, packed - hi))
    return packed


def pack_pass(weights, route: str, c_in: int, c: int) -> list:
    """The four stages' weights packed for ``route`` (compute dtype)."""
    elem = weights[0].element_size()
    if route == "fused":
        sbs = [stream_sb(3, c_in, elem) if fused_streams(c_in, elem) else 0, 0, 0, 0]
    else:
        sbs = [stream_sb(k, ci, elem) for k, ci in ((3, c_in), (1, c), (1, c), (3, c))]
    return [pack_stage(w, sb) for w, sb in zip(weights, sbs)]


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


def _plain(x, weights, biases, compute_dtype):
    """The four stages of the plain version on checked arguments."""
    y = x.to(compute_dtype).permute(0, 3, 1, 2).float()
    for w, b in zip(weights, biases):
        w = w.to(compute_dtype).float().permute(3, 2, 0, 1)  # (C, C_in, kh, kw)
        y = F.relu(F.conv2d(y, w, b.float())).to(compute_dtype).float()
    return y.to(compute_dtype).permute(0, 2, 3, 1).contiguous()


def conv_pass_2d_plain(
    x: torch.Tensor, pass_params: dict, compute_dtype=torch.float32
) -> torch.Tensor:
    """Plain PyTorch version: ``(B, H, W, C_in) -> (B, H-4, W-4, C)`` in
    ``compute_dtype``. Each stage convolves compute-dtype values in f32,
    adds the f32 bias, applies ReLU and rounds to the compute dtype."""
    weights, biases = _checked_args(x, pass_params, compute_dtype)
    return _plain(x, weights, biases, compute_dtype)


def conv_pass_2d_plan(shape, c_out: int, compute_dtype):
    """The route and square output tile an NHWC input of ``shape`` takes:
    ``("fused", t)``, the tile of at least ``FUSED_MIN_TILE`` that fits one
    block and that the cost model rates cheapest (the larger one on a tie);
    where none fits, ``("staged", t)``, the largest staged tile whose four
    stages fit, if the channels allow it; else the cheapest smaller fused
    tile. Raise ``ValueError`` when no route takes the shape."""
    elem = torch.tensor([], dtype=compute_dtype).element_size()
    _, H, W, c_in = shape
    fits = [t for t in TILE_CANDIDATES
            if fused_smem_bytes(c_in, c_out, t, t, elem) <= MAX_SHARED_BYTES]

    def cheapest(tiles):
        return "fused", min(tiles, key=lambda t: fused_cost(c_in, c_out, t, t, H, W, elem))

    if any(t >= FUSED_MIN_TILE for t in fits):
        return cheapest([t for t in fits if t >= FUSED_MIN_TILE])
    kstep = _CFG[elem]["kstep"]
    if c_in % kstep == 0 and c_out % kstep == 0:
        for t in (STAGED_TILE, *[c for c in TILE_CANDIDATES if c < STAGED_TILE]):
            if max(staged_smem_bytes(k, ci, t, t, elem)
                   for k, ci in ((3, c_in), (1, c_out), (3, c_out))) <= MAX_SHARED_BYTES:
                return "staged", t
    if fits:
        return cheapest(fits)
    raise ValueError(
        f"conv pass {c_in}->{c_out} channels fits no fused tile, and the staged route "
        f"takes channels in multiples of {kstep} only"
    )


def conv_pass_2d_design(shape, c_out: int, compute_dtype) -> str:
    """The kernel's design for an NHWC input of ``shape`` (``csrc/conv_pass.cu``):
    its wgmma, route and output tile."""
    route, tile = conv_pass_2d_plan(shape, c_out, compute_dtype)
    mma = ("wgmma m64n64k16 bf16" if compute_dtype == torch.bfloat16
           else "wgmma m64n64k8 3xTF32")
    where = "fused" if route == "fused" else "staged, one launch a stage"
    return f"{mma}, {where}, {tile}x{tile} tile, 2 consumer warpgroups"


def conv_pass_2d(
    x: torch.Tensor, pass_params: dict, compute_dtype=torch.float32
) -> torch.Tensor:
    """Fused conv pass, channels-last: the custom op
    ``cellulus_tpu_torch::conv_pass_2d`` on checked arguments.

    Args:
        x: ``(B, H, W, C_in)``.
        pass_params: ``{"conv0": {"w", "b"}, ..., "conv3": {...}}`` with
            ``w`` of shape ``(kh, kw, C_in, C_out)`` and ``b`` of ``(C_out,)``
            (the layout of the JAX package's params).
        compute_dtype: ``torch.float32`` or ``torch.bfloat16``.

    Returns:
        ``(B, H-4, W-4, C_out)`` in ``compute_dtype``.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_pass_2d runs on CUDA or CPU tensors, not {x.device}")
    weights, biases = _checked_args(x, pass_params, compute_dtype)
    return torch.ops.cellulus_tpu_torch.conv_pass_2d(x, *weights, *biases, compute_dtype)


conv_pass_2d.launches = 0


# The pass as a torch.library custom op, so that torch.export keeps each
# pass as one node (``cellulus_tpu_torch/export.py``). Registering it loads
# no library: the CUDA implementation builds or loads K1 at its first call.
@torch.library.custom_op("cellulus_tpu_torch::conv_pass_2d", mutates_args=(),
                         device_types="cpu")
def _conv_pass_op(
    x: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor,
    b0: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor, b3: torch.Tensor,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """On CPU tensors: the plain version."""
    return _plain(x, (w0, w1, w2, w3), (b0, b1, b2, b3), compute_dtype)


@_conv_pass_op.register_fake
def _(x, w0, w1, w2, w3, b0, b1, b2, b3, compute_dtype):
    B, H, W, _ = x.shape
    return x.new_empty((B, H - 4, W - 4, w0.shape[-1]), dtype=compute_dtype)


@_conv_pass_op.register_kernel("cuda")
def _(x, w0, w1, w2, w3, b0, b1, b2, b3, compute_dtype):
    """On CUDA tensors: one launch of K1's route for this shape."""
    B, H, W, c_in = x.shape
    c_out = w0.shape[-1]
    route, tile = conv_pass_2d_plan(x.shape, c_out, compute_dtype)
    lib = kernels.load("conv_pass", _SIGNATURES)
    # repack once per call: the weights into the layout the kernel's wgmma
    # reads (pack_stage), f32 biases
    x = x.to(compute_dtype).contiguous()
    ws = pack_pass([w.to(compute_dtype) for w in (w0, w1, w2, w3)], route, c_in, c_out)
    bs = [b.float().contiguous() for b in (b0, b1, b2, b3)]
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
    kernels.count_launch(conv_pass_2d)
    return out
