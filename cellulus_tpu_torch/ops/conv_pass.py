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
rates cheapest; and the staged route, one launch per stage with the
intermediates in device memory in the compute dtype. In float32 the staged
route takes a pass where no such fused tile fits (the bottom pass of a
256-fmap model), at the square tile of the plan. In bfloat16 it takes a
pass wherever a cost model of both routes rates it faster (every pass of
the 64- and 256-fmap models): a stage is a persistent implicit GEMM of
128-pixel x 256-channel tiles, or of two rows of 128 pixels x 64 channels
where the pass has 64 output channels or fewer (:func:`staged_plan`
mirrors its plan), and a first stage of fewer than 8 input channels runs
on the CUDA cores (:func:`first_plan`). The plan is computed here from
Python mirrors of the source's size and cost formulas (``chip_smoke.py``
holds them against the library's, and a CPU test against a g++ build of
the staged plan's lines), so the CPU tests can check the route of every
pass. Before each launch the wrapper packs the weights into the layout the
kernel's ``wgmma`` reads from its ring (:func:`pack_stage`, float32 as tf32
hi and lo arrays; :func:`pack_stage_bf16` for the bfloat16 staged route),
which the CPU tests check too.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils import kernels
from ..utils.profiling import count

# dynamic shared memory one block may use on Hopper (227 KB)
MAX_SHARED_BYTES = 232448
TILE_CANDIDATES = (24, 20, 16, 14, 12, 10, 8, 6, 4, 2, 1)
# the fused route takes a tile below this only where the staged route cannot
# take the pass (a block of fewer pixels leaves a consumer warpgroup idle)
FUSED_MIN_TILE = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_SIZES = (3, 1, 1, 3)

# the staged route's output tile in float32 (one per stage)
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
    "conv_pass_2d_staged_plan": ([ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)],
                                 ctypes.c_int),
    "conv_pass_2d_route_cost": ([ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)],
                                ctypes.c_int),
    "conv_pass_2d_stage_launch": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
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

# csrc/conv_pass.cu's bf16 staged route (conv_stage_kernel_persistent<BN>):
# tiles of BM output pixels x BN output channels (BN = GEMM_N = 256, BM =
# 128 where C > 64; BN = 64, BM = 256 where C <= 64), K in chunks of GEMM_K
# input channels at one tap (BN = 256) or one tap row (BN = 64); a ring
# slot holds the chunk's A (one TMA box) and B (one bulk copy of the pack),
# beside the epilogue's output tile
GEMM_N, GEMM_K = 256, 64
_GEMM_MAX_SLOTS = 8
_GEMM_ALIGN = 1024
# its CUDA-core stage (conv_stage_kernel_first), for cin % 8 != 0: blocks of
# FIRST_THREADS threads, a thread FIRST_PIX pixels of a row x 8 channels
FIRST_THREADS, FIRST_PIX = 256, 4
# the cost model of the routes (csrc/conv_pass.cu, between the "K1 staged
# plan" markers), in picoseconds on an H100 SXM; at 64 columns a tap's time
SMS = 132
_CHUNK_PS = {256: 646000, 64: 384000}
_TILE_PS = {256: 1950000, 64: 870000}
_FIRST_FMA_PER_PS = 7
_FUSED_UNIT_PS = 110000


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


def gemm_bn(c: int) -> int:
    """Output channels of a persistent tile: 64 where ``c`` <= 64, else 256."""
    return 64 if c <= 64 else 256


def gemm_bm(bn: int) -> int:
    """Output pixels of a persistent tile of ``bn`` channels."""
    return 256 if bn == 64 else 128


def staged_plan(B: int, oh: int, ow: int, k: int, c_in: int, c: int) -> dict:
    """Mirror of ``gemm_plan`` (``conv_pass_2d_staged_plan``), the bf16
    staged route's plan of a ``k x k`` stage with an ``oh x ow`` output grid
    on the persistent kernel: the tile of ``bm`` pixels x ``bn`` channels
    (:func:`gemm_bn`), the box of its pixels (``bh`` x ``bw``: at 256
    columns ``bh`` in 1, 2, 4, 8, the one that pads the grid least, the
    widest on a tie; at 64 columns two rows of 128), the boxes over an image
    and the batch, the ``bn``-column n-tiles, the tiles the persistent
    blocks walk, the 64-channel blocks of ``c_in``, the chunks a tile and
    the taps a chunk (at 64 columns a tap row's ``k`` taps, its input box
    ``box_w`` = ``bw + k - 1`` wide), a chunk's input box (``a_tx`` bytes,
    ``a_bytes`` of room, 1024-aligned) and weights (``b_bytes``), the
    ring's slots and the shared bytes (the ring, the epilogue's output
    tile, the barriers and 1024 bytes of alignment slack)."""
    bn = gemm_bn(c)
    bm = gemm_bm(bn)
    if bn == GEMM_N:
        area = {h: _ceil(oh, h) * h * _ceil(ow, bm // h) * (bm // h) for h in (1, 2, 4, 8)}
        bh = min(area, key=lambda h: (area[h], h))
    else:
        bh = 2
    bw = bm // bh
    tiles_y, tiles_x = _ceil(oh, bh), _ceil(ow, bw)
    m_tiles, n_tiles = B * tiles_y * tiles_x, _ceil(c, bn)
    n_cb = _ceil(c_in, GEMM_K)
    taps = k if bn == 64 else 1
    box_w = bw + taps - 1
    a_tx = bh * box_w * GEMM_K * 2
    a_bytes = _ceil(a_tx, _GEMM_ALIGN) * _GEMM_ALIGN
    b_bytes = taps * bn * GEMM_K * 2
    fixed = _GEMM_ALIGN + bm * bn * 2 + 2 * _GEMM_MAX_SLOTS * 8
    slots = min(_GEMM_MAX_SLOTS, (MAX_SHARED_BYTES - fixed) // (a_bytes + b_bytes))
    return dict(bm=bm, bn=bn, bh=bh, bw=bw, tiles_y=tiles_y, tiles_x=tiles_x, m_tiles=m_tiles,
                n_tiles=n_tiles, tiles=m_tiles * n_tiles, n_cb=n_cb,
                chunks=k * k * n_cb // taps, taps=taps, box_w=box_w, a_tx=a_tx,
                a_bytes=a_bytes, b_bytes=b_bytes, slots=slots,
                smem=fixed + slots * (a_bytes + b_bytes))


def staged_tile(plan: dict, t: int):
    """Mirror of ``gemm_tile``: ``(img, y0, x0, nt)`` of tile ``t`` of the
    blocks' walk, the n-tiles of one m-tile neighbours."""
    nt, m = t % plan["n_tiles"], t // plan["n_tiles"]
    img, r = divmod(m, plan["tiles_y"] * plan["tiles_x"])
    return img, (r // plan["tiles_x"]) * plan["bh"], (r % plan["tiles_x"]) * plan["bw"], nt


def first_plan(B: int, oh: int, ow: int, k: int, c_in: int, c: int) -> dict:
    """Mirror of ``first_plan``, the CUDA-core stage's plan: the 8-channel
    groups of ``c`` (a pixel group's threads), the pixel groups a block
    takes at once, the pixel groups of the batch (``FIRST_PIX`` pixels of a
    row each) and the weights' shared bytes (f32)."""
    groups = c // 8
    return dict(groups=groups, per_block=FIRST_THREADS // groups if groups else 0,
                items=B * oh * _ceil(ow, FIRST_PIX), smem=4 * k * k * c_in * c)


def staged_takes(c_in: int, c: int) -> bool:
    """Mirror of ``staged_takes``: whether the bf16 staged route takes a
    pass of ``c_in`` -> ``c`` channels (outputs TMA-strided, the first stage
    on the persistent kernel or on the CUDA cores)."""
    if c % 8:
        return False
    return c_in % 8 == 0 or (c // 8 <= FIRST_THREADS
                             and first_plan(1, 1, 1, 3, c_in, c)["smem"] <= MAX_SHARED_BYTES)


def _hbm_ps(nbytes: int) -> int:
    return nbytes * 1000 // 3350


def staged_stage_ps(B: int, H: int, W: int, k: int, c_in: int, c: int) -> int:
    """Mirror of ``staged_stage_ps``: the cost model's picoseconds of one
    bf16 staged stage, the larger of its compute (the persistent kernel's
    busiest block: tiles x (chunks x a chunk (a tap's time where a chunk
    holds a tap row) + a tile's epilogue); the CUDA-core stage's FMAs) and
    its input and output through HBM."""
    oh, ow = H - k + 1, W - k + 1
    out = B * oh * ow * c
    io = _hbm_ps(2 * (B * H * W * c_in + out))
    if c_in % 8:
        t = out * k * k * c_in // _FIRST_FMA_PER_PS
    else:
        p = staged_plan(B, oh, ow, k, c_in, c)
        t = _ceil(p["tiles"], SMS) * (p["chunks"] * p["taps"] * _CHUNK_PS[p["bn"]]
                                      + _TILE_PS[p["bn"]])
    return max(t, io)


def staged_pass_ps(B: int, H: int, W: int, c_in: int, c: int) -> int:
    """Mirror of ``staged_pass_ps``: the four stages' picoseconds."""
    return (staged_stage_ps(B, H, W, 3, c_in, c) + 2 * staged_stage_ps(B, H - 2, W - 2, 1, c, c)
            + staged_stage_ps(B, H - 2, W - 2, 3, c, c))


def fused_pass_ps(B: int, cost: int) -> int:
    """Mirror of ``fused_pass_ps``: the fused route's picoseconds at a tile
    of cost ``cost`` (:func:`fused_cost`), one block an SM."""
    return B * cost * _FUSED_UNIT_PS // SMS


def staged_work(shape, c_out: int) -> dict:
    """Work the bf16 staged route does for a pass of NHWC input ``shape``,
    by kernel: ``{"k1.staged_tiles": ..., "k1.staged_tiles_n64": ...,
    "k1.first_pixels": ...}``, the persistent kernel's tiles of 256 and of
    64 columns (``staged_plan``) and the output pixels of the CUDA-core
    stage; kernels the pass does not run are left out."""
    B, H, W, c_in = shape
    stages = ((H - 2, W - 2, 3, c_in), (H - 2, W - 2, 1, c_out), (H - 2, W - 2, 1, c_out),
              (H - 4, W - 4, 3, c_out))
    work = {}
    for oh, ow, k, ci in stages:
        if ci % 8:
            key, n = "k1.first_pixels", B * oh * ow
        else:
            p = staged_plan(B, oh, ow, k, ci, c_out)
            key = "k1.staged_tiles" if p["bn"] == GEMM_N else "k1.staged_tiles_n64"
            n = p["tiles"]
        work[key] = work.get(key, 0) + n
    return work


def staged_smem_bytes(k: int, c_in: int, th: int, tw: int, elem: int) -> int:
    """Mirror of ``conv_pass_2d_staged_smem_bytes``: a block of the staged
    route at a ``k x k`` stage with ``c_in`` input channels; in float32 at a
    ``th x tw`` output tile (barriers, its output tile's staging area, the
    ring), in bfloat16 the persistent kernel's bytes, the same at every shape."""
    if elem == 2:
        return staged_plan(1, 1, 1, k, c_in, GEMM_N)["smem"]
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


def sw128_units(n: int, device=None) -> torch.Tensor:
    """``(n, 8)``: the 16-byte unit that row r's unit u occupies in a tile
    of 128-byte rows laid out with the 128-byte swizzle, ``u ^ (r % 8)``
    (TMA's SWIZZLE_128B, and the layout the kernel's K-major descriptors
    name)."""
    return (torch.arange(8, device=device)[None, :]
            ^ (torch.arange(n, device=device)[:, None] % 8))


def pack_stage_persistent(w: torch.Tensor) -> torch.Tensor:
    """One stage's bf16 weights ``(k, k, c_in, c)`` packed for the bf16
    staged route's persistent kernel: ``(n_tiles, chunks, bn, 64)`` (``bn``
    = :func:`gemm_bn` of ``c``), per ``bn``-column n-tile and chunk (input
    channels 64 (c // k^2) .., tap c % k^2) the ``bn`` output columns' 64
    K values each in a 128-byte row, K-major, its 16-byte units swizzled
    (:func:`sw128_units`), so that a chunk is one contiguous copy (32 or 8
    KB) that the wgmma descriptor reads as it lands. Channels past ``c_in``
    and columns past ``c`` are zeros."""
    k, _, c_in, c = w.shape
    bn = gemm_bn(c)
    n_cb, n_t = _ceil(c_in, GEMM_K), _ceil(c, bn)
    rows = F.pad(w.reshape(k * k, c_in, c), (0, n_t * bn - c, 0, n_cb * GEMM_K - c_in))
    # (tap, block, k, n-tile, n) -> (n-tile, block, tap, n, unit, 8)
    t = rows.reshape(k * k, n_cb, GEMM_K, n_t, bn).permute(3, 1, 0, 4, 2)
    t = t.reshape(n_t, k * k * n_cb, bn, GEMM_K // 8, 8)
    # unit s of row n holds the source unit s ^ (n % 8) (the XOR is its own
    # inverse); the indices are made where w is, so that packing on the card
    # copies nothing from the host (a pageable copy would hold the host until
    # the card has run everything queued before it)
    n = torch.arange(bn, device=w.device)[:, None]
    packed = t[:, :, n, sw128_units(bn, w.device)]
    return packed.reshape(n_t, k * k * n_cb, bn, GEMM_K).contiguous()


def pack_stage_bf16(w: torch.Tensor) -> torch.Tensor:
    """One stage's bf16 weights for the bf16 staged route: the persistent
    kernel's pack, or, where the stage's input channels are not a multiple
    of 8 (the CUDA-core stage), the plain ``(k, k, c_in, c)`` array."""
    return w.contiguous() if w.shape[2] % 8 else pack_stage_persistent(w)


def pack_pass(weights, route: str, c_in: int, c: int) -> list:
    """The four stages' weights packed for ``route`` (compute dtype)."""
    elem = weights[0].element_size()
    if route == "staged" and elem == 2:
        return [pack_stage_bf16(w) for w in weights]
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
    """The route and square output tile an NHWC input of ``shape`` takes.
    The fused route's tile is the one of at least ``FUSED_MIN_TILE`` that
    fits one block and that the cost model rates cheapest (the larger one on
    a tie). In bfloat16 the staged route (:func:`staged_takes`) takes the
    pass where its cost model's time (:func:`staged_pass_ps`, the
    intermediates' bytes through device memory counted) is below the fused
    tile's (:func:`fused_pass_ps`, its halo recompute and padding counted),
    or where no such fused tile fits. In float32 the fused tile is taken
    where one fits; else ``("staged", t)``, the largest staged tile whose
    four stages fit, if the channels allow it. Else the cheapest smaller
    fused tile. Raise ``ValueError`` when no route takes the shape.
    (bfloat16's staged stages take their own tiles, :func:`staged_plan`:
    ``t`` is then ``STAGED_TILE`` and unused.)"""
    elem = torch.tensor([], dtype=compute_dtype).element_size()
    B, H, W, c_in = shape
    fits = [t for t in TILE_CANDIDATES
            if fused_smem_bytes(c_in, c_out, t, t, elem) <= MAX_SHARED_BYTES]
    big = [t for t in fits if t >= FUSED_MIN_TILE]

    def cheapest(tiles):
        return min(tiles, key=lambda t: fused_cost(c_in, c_out, t, t, H, W, elem))

    if elem == 2 and staged_takes(c_in, c_out):
        if big:
            t = cheapest(big)
            fused_ps = fused_pass_ps(B, fused_cost(c_in, c_out, t, t, H, W, elem))
            if fused_ps <= staged_pass_ps(B, H, W, c_in, c_out):
                return "fused", t
        return "staged", STAGED_TILE
    if big:
        return "fused", cheapest(big)
    kstep = _CFG[elem]["kstep"]
    if elem == 4 and c_in % kstep == 0 and c_out % kstep == 0:
        for t in (STAGED_TILE, *[c for c in TILE_CANDIDATES if c < STAGED_TILE]):
            if max(staged_smem_bytes(k, ci, t, t, elem)
                   for k, ci in ((3, c_in), (1, c_out), (3, c_out))) <= MAX_SHARED_BYTES:
                return "staged", t
    if fits:
        return "fused", cheapest(fits)
    raise ValueError(
        f"conv pass {c_in}->{c_out} channels fits no fused tile, and the staged route "
        f"takes channels in multiples of {kstep if elem == 4 else 8} only"
    )


def conv_pass_2d_design(shape, c_out: int, compute_dtype) -> str:
    """The kernel's design for an NHWC input of ``shape`` (``csrc/conv_pass.cu``):
    its wgmma, route and output tile."""
    route, tile = conv_pass_2d_plan(shape, c_out, compute_dtype)
    if route == "staged" and compute_dtype == torch.bfloat16:
        B, H, W, c_in = shape
        parts = []
        for k, ci, h, w in ((3, c_in, H, W), (1, c_out, H - 2, W - 2), (3, c_out, H - 2, W - 2)):
            if ci % 8:
                parts.append(f"{k}x{k} {ci}->{c_out} on the CUDA cores")
                continue
            p = staged_plan(B, h - k + 1, w - k + 1, k, ci, c_out)
            mma = "m64n256k16" if p["bn"] == GEMM_N else "m64n128k16 weights as A"
            parts.append(f"{k}x{k} {ci}->{c_out} {mma}, {p['bm']} x {p['bn']} tiles "
                         f"({p['bh']}x{p['bw']} boxes)")
        return ("staged, one persistent launch a stage, wgmma A and B from 128-byte swizzled "
                "shared memory, 2 consumer warpgroups and a producer warp: " + "; ".join(parts))
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
    kernels.account(_account_launch, tuple(x.shape), c_out, route, compute_dtype)
    return out


def _account_launch(shape, c_out: int, route: str, compute_dtype) -> None:
    """One launch of K1 on an input of ``shape``: its launch count and, on
    the bf16 staged route, the counters of its work."""
    kernels.count_launch(conv_pass_2d)
    if route == "staged" and compute_dtype == torch.bfloat16:
        work = staged_work(shape, c_out)
        if "k1.staged_tiles" in work:
            count("k1.staged_tiles", work["k1.staged_tiles"])
        if "k1.staged_tiles_n64" in work:
            count("k1.staged_tiles_n64", work["k1.staged_tiles_n64"])
        if "k1.first_pixels" in work:
            count("k1.first_pixels", work["k1.first_pixels"])
