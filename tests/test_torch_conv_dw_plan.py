"""K2's plan and data path on the CPU (``csrc/conv_dw.cu``).

- The Python mirrors of the plan (``ops/conv_dw.py``: route, chunk, shared
  memory, pixel splits, chunk origins) against a g++ build of the source's
  lines between its "K2 plan begin" and "K2 plan end" markers, on stub
  CUDA qualifiers.
- The plan at the train step's and the ragged shapes: every output pixel
  in exactly one chunk of exactly one split, the splits one wave, the
  shared memory within the card's 227 KB.
- A numpy emulation of the kernel's data path, from the bytes of a ring
  stage up: the TMA boxes with their zero fill and 128-byte swizzle, the
  per-lane ldmatrix.trans and 32-bit load addresses of the tap-shifted A
  rows (and route 2's (tap, ci) rows), the swizzled MN-major descriptor
  addressing of the bf16 g tile,
  the f32 split of the g tile into K-major tf32 hi and lo slabs read by the
  K-major descriptor, 3xTF32 with per-chunk partial sums from zero, and the
  fixed-order split reduction; held against ``conv3x3_dw_plain`` with the
  card's tolerances.
"""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cellulus_tpu_torch.models.geometry import conv_pass_inputs
from cellulus_tpu_torch.ops import conv_dw as k2
from tests import tf32x3

SOURCE = k2.__file__.replace("ops/conv_dw.py", "csrc/conv_dw.cu")


def _dw_shapes(batch, crop, model, in_channels=1):
    """(x shape, g shape) of the first and last conv of every pass."""
    out = []
    for _, (h, w), c_in, c in conv_pass_inputs((crop, crop), [[2, 2]], in_channels, *model):
        out.append(((batch, h, w, c_in), (batch, h - 2, w - 2, c)))
        out.append(((batch, h - 2, w - 2, c), (batch, h - 4, w - 4, c)))
    return out


# the train step of examples/2d (64 fmaps, x3, 64 last; batch 8 x 252^2) and
# its 3-channel first conv; the gate model (16, x2, 24) at 4 x 76^2; the
# sweep model's widths; B = 1 at sizes that are no multiple of a chunk
TRAIN = _dw_shapes(8, 252, (64, 3, 64)) + _dw_shapes(8, 252, (64, 3, 64), 3)[:1]
RAGGED = _dw_shapes(4, 76, (16, 2, 24)) + [
    ((1, 37, 45, 3), (1, 35, 43, 24)), ((1, 29, 33, 24), (1, 27, 31, 72)),
    ((2, 27, 31, 96), (2, 25, 29, 24)), ((1, 53, 47, 72), (1, 51, 45, 24)),
    ((1, 15, 14, 3), (1, 13, 12, 7)), ((1, 11, 12, 12), (1, 9, 10, 20)),
]
SHAPES = TRAIN + RAGGED
ELEMS = (2, 4)


# --- the plan against a g++ build of the source's formulas ----------------

_MAIN = r"""
#include <cstdio>
int main() {
  int B, H, W, Ci, Co, E, sms;
  while (std::scanf("%d %d %d %d %d %d %d", &B, &H, &W, &Ci, &Co, &E, &sms) == 7) {
    DwGrid gr = E == 2 ? dw_grid<2>(B, H, W, Ci, Co) : dw_grid<4>(B, H, W, Ci, Co);
    DwLayout L = E == 2 ? dw_layout<2>(gr.fold) : dw_layout<4>(gr.fold);
    int s = E == 2 ? dw_splits<2>(B, H, W, Ci, Co, sms) : dw_splits<4>(B, H, W, Ci, Co, sms);
    int b, y0, x0;
    if (E == 2) dw_chunk<2>(gr.n_chunks - 1, gr.chunks_y, gr.chunks_x, b, y0, x0);
    else dw_chunk<4>(gr.n_chunks - 1, gr.chunks_y, gr.chunks_x, b, y0, x0);
    std::printf("%d %d %d %d %d %lld %d %d %d %d %d %d %d %d %d %lld %d %d %d %d %d\n",
                gr.fold, gr.n_ci_blocks, gr.n_co_blocks, gr.chunks_y, gr.chunks_x, gr.n_chunks, s,
                L.xbox, L.xbytes, L.gbytes, L.stage, L.slab, L.stages, L.slabs, L.bars, L.total, b,
                y0, x0, dw_plan_bits(Ci, Co, E), sw128(B + H, Ci % 128));
  }
}
"""


def _python_plan(B, H, W, Ci, Co, E, sms):
    gr = k2.grid(B, H, W, Ci, Co, E)
    L = k2.layout(E, gr["fold"])
    b, y0, x0 = k2.chunk_origin(gr["n_chunks"] - 1, gr["chunks_y"], gr["chunks_x"], E)
    return [int(gr["fold"]), gr["n_ci_blocks"], gr["n_co_blocks"], gr["chunks_y"],
            gr["chunks_x"], gr["n_chunks"], k2.splits(B, H, W, Ci, Co, E, sms)] + [
        L[k] for k in ("xbox", "xbytes", "gbytes", "stage", "slab", "stages", "slabs", "bars",
                       "total")
    ] + [b, y0, x0, k2.conv3x3_dw_plan(Ci, Co, E), k2.sw128(B + H, Ci % 128)]


def _plan_cases():
    rng = np.random.default_rng(14)
    cases = [(*xs, gs[-1]) for xs, gs in SHAPES]
    for _ in range(40):
        cases.append((int(rng.integers(1, 9)), int(rng.integers(3, 300)), int(rng.integers(3, 300)),
                      int(rng.integers(1, 400)), int(rng.integers(1, 400))))
    return [(*c, e, sms) for c in cases for e in ELEMS for sms in (132, 114)]


@pytest.fixture(scope="module")
def plan_binary(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the source's plan formulas")
    src = open(SOURCE).read()
    body = re.search(r"// ---- K2 plan begin.*?\n(.*)// ---- K2 plan end", src, re.S).group(1)
    stub = "#define __host__\n#define __device__\n"
    d = tmp_path_factory.mktemp("k2plan")
    (d / "plan.cpp").write_text(stub + body + _MAIN)
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(d / "plan"), str(d / "plan.cpp")],
                   check=True, capture_output=True, text=True)
    cases = _plan_cases()
    out = subprocess.run([str(d / "plan")], input="\n".join(" ".join(map(str, c)) for c in cases),
                         capture_output=True, text=True, check=True).stdout.split("\n")
    return {c: [int(v) for v in line.split()] for c, line in zip(cases, out)}


@pytest.mark.parametrize("elem", ELEMS)
def test_plan_mirrors_equal_the_source(plan_binary, elem):
    cases = [c for c in plan_binary if c[5] == elem]
    assert len(cases) > 100
    for c in cases:
        assert _python_plan(*c) == plan_binary[c], c


@pytest.mark.parametrize("elem", ELEMS)
@pytest.mark.parametrize("xs,gs", SHAPES, ids=[f"{x}->{g[-1]}" for x, g in SHAPES])
def test_every_output_pixel_in_one_chunk_of_one_split(xs, gs, elem):
    B, H, W, Ci = xs
    Co = gs[-1]
    gr = k2.grid(B, H, W, Ci, Co, elem)
    c = k2.CHUNKING[elem]
    L = k2.layout(elem, gr["fold"])
    assert L["total"] <= k2.MAX_SMEM and 2 <= L["stages"] <= 8
    if gr["fold"]:  # the dense x tile fits its area
        assert (c.ty + 2) * (c.tx + 2) * Ci * elem <= L["xbytes"]
    n_splits = k2.splits(B, H, W, Ci, Co, elem, 132)
    assert 1 <= n_splits * gr["n_ci_blocks"] * gr["n_co_blocks"] <= max(
        132, gr["n_ci_blocks"] * gr["n_co_blocks"])
    ranges = k2.split_chunks(B, H, W, Ci, Co, elem, n_splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == gr["n_chunks"]
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    cover = np.zeros((B, H - 2 + c.ty, W - 2 + c.tx), np.int32)
    for lo, hi in ranges:
        for ch in range(lo, hi):
            b, y0, x0 = k2.chunk_origin(ch, gr["chunks_y"], gr["chunks_x"], elem)
            cover[b, y0:y0 + c.ty, x0:x0 + c.tx] += 1
    assert (cover[:, :H - 2, :W - 2] == 1).all()
    assert cover.sum() == gr["n_chunks"] * c.ty * c.tx


# --- the data path ---------------------------------------------------------


def _box(a, b, y0, x0, c0, bh, bw, bc):
    """A TMA box of NHWC ``a`` at (c0, x0, y0, b): (bh, bw, bc), zeros where
    it leaves the tensor."""
    out = np.zeros((bh, bw, bc), a.dtype)
    h = max(0, min(bh, a.shape[1] - y0))
    w = max(0, min(bw, a.shape[2] - x0))
    c = max(0, min(bc, a.shape[3] - c0))
    out[:h, :w, :c] = a[b, y0:y0 + h, x0:x0 + w, c0:c0 + c]
    return out


class Stage:
    """The bytes of one ring stage: float32, or bfloat16 kept as its bits."""

    def __init__(self, L, elem):
        self.raw = np.zeros(L["stage"], np.uint8)
        self.dtype = np.float32 if elem == 4 else np.uint16

    def put(self, off, arr, swizzle=False):
        """A box (rows, ..., 128 bytes or fewer a row) at byte off, its
        128-byte rows swizzled as TMA's SWIZZLE_128B writes them."""
        b = np.ascontiguousarray(arr, self.dtype).view(np.uint8).ravel()
        if swizzle:
            i = np.arange(b.size)
            self.raw[off + k2.sw128(i // 128, i % 128)] = b
        else:
            self.raw[off:off + b.size] = b

    def elem(self, byte_addr):
        """The elements at byte addresses (any shape), as float32."""
        addr = np.asarray(byte_addr)
        e = np.dtype(self.dtype).itemsize
        assert (addr % e == 0).all()
        v = self.raw.view(self.dtype)[addr // e]
        return v if e == 4 else (v.astype(np.uint32) << 16).view(np.float32)


def _load_stage(st, x, g, b, y0, x0, ci0, co0, L, c, fold, elem):
    """What the producer puts in a stage for chunk (b, y0, x0)."""
    if fold:  # route 2: the dense x tile [pixel][Ci] by element copies
        st.put(0, _box(x, b, y0, x0, 0, c.ty + 2, c.tx + 2, x.shape[3]))
    else:  # a swizzled box per 128 bytes of channels
        per = 128 // elem
        for h in range(k2.CI_BLOCK // per):
            st.put(h * L["xbox"], _box(x, b, y0, x0, ci0 + h * per, c.ty + 2, c.tx + 2, per), True)
    # one box [pixel][NB]: swizzled in bf16
    st.put(L["xbytes"], _box(g, b, y0, x0, co0, c.ty, c.tx, c.nb), elem == 2)


def _b_mn_sw128(st, base, group, K, N):
    """B (K x N, N = 64 bf16) read by an MN-major descriptor in 128-byte
    swizzle: k row i at 128 i within its 8-row group, groups ``group``
    bytes apart, and the hardware's swizzle on the address, bits [4, 7)
    XORed with bits [7, 10) (base 1024-byte aligned)."""
    assert base % 1024 == 0 and N == 64
    k = np.arange(K)[:, None]
    n = np.arange(N)[None, :]
    a = base + (k // 8) * group + (k % 8) * 128 + n * 2
    return st.elem(a ^ (((a >> 7) & 7) << 4))


def _b_k(mem, base, lbo, sbo, K, N):
    """B (K x N) read by a K-major descriptor without swizzle from f32 words:
    core matrices of 8 n rows x 16 bytes (4 tf32) of k; LBO adjacent in k,
    SBO adjacent in n."""
    k = np.arange(K)[:, None]
    n = np.arange(N)[None, :]
    addr = base + (k // 4) * lbo + (n // 8) * sbo + (n % 8) * 16 + (k % 4) * 4
    return mem[addr // 4]


def _lanes():
    lane = np.arange(32)
    return lane, lane >> 2, lane & 3


def _a_bf16_taps(st, L, c, kx, col, r):
    """Route 1, bf16: the A tile (64 ci x 16 pixels) warp w's ldmatrix.x4.trans
    gives for x row r of column col, from the kernel's per-lane row addresses."""
    lane, gq, t = _lanes()
    A = np.zeros((64, 16), np.float32)
    for w in range(4):
        a_p = (lane & 7) + ((lane >> 4) << 3) + kx
        a_b = (2 * w + ((lane >> 3) & 1)) * 16
        row = k2.sw128(col * c.ks + a_p + r * (c.tx + 2), a_b)
        mats = st.elem(row[:, None] + 2 * np.arange(8)[None, :])  # (32 lanes, 8)
        # matrix j's row i comes from lane 8 j + i; .trans gives lane l the
        # elements (row 2 (l % 4) + {0, 1}, column l / 4) of each matrix
        for j in range(4):
            m = mats[8 * j:8 * j + 8]
            v0, v1 = m[2 * t, gq], m[2 * t + 1, gq]
            rows = 16 * w + gq + 8 * (j & 1)
            ks = 2 * t + 8 * (j >> 1)
            A[rows, ks], A[rows, ks + 1] = v0, v1
    return A


def _a_f32_taps(st, L, c, kx, col, r):
    """Route 1, f32: the A tile (64 ci x 8 pixels) of the four 32-bit loads a
    lane makes for x row r of column col."""
    lane, gq, t = _lanes()
    A = np.zeros((64, 8), np.float32)
    for w in range(4):
        ca, cb = 16 * w + gq, 16 * w + gq + 8
        xh = (w >> 1) * L["xbox"]
        ba = ((16 * w + gq) & 31) * 4
        p = col * c.ks + t + kx + r * (c.tx + 2)
        for j, (rows, pp, b) in enumerate(((ca, p, ba), (cb, p, ba + 32), (ca, p + 4, ba),
                                           (cb, p + 4, ba + 32))):
            A[rows, t + 4 * (j >> 1)] = st.elem(xh + k2.sw128(pp, b))
    return A


def _a_fold(st, c, Ci, s, col, elem):
    """Route 2: the A tile (64 (tap, ci) rows x KS pixels) of the per-lane
    element loads from the dense x tile; rows past 9 Ci zero."""
    lane, gq, t = _lanes()
    xw = c.tx + 2
    A = np.zeros((64, c.ks), np.float32)
    ks = ([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9] if elem == 2 else [t, t + 4])
    for w in range(4):
        for h in range(2):
            m = 16 * w + gq + 8 * h
            ok = m < 9 * Ci
            tap = np.where(ok, m // Ci, 0)
            ci = np.where(ok, m - tap * Ci, 0)
            off = ((tap // 3) * xw + tap % 3) * Ci + ci
            base = (s * xw + col * c.ks) * Ci
            for k in ks:
                A[m, k] = np.where(ok, st.elem((base + k * Ci + off) * elem), 0.0)
    return A


def _split_g(st, L, c):
    """f32: the landed g tile [pixel][NB] into the K-major slabs [p/4][NB][4]
    hi and lo, as split_g writes them (lo = v - hi whole)."""
    raw = st.elem(L["xbytes"] + 4 * np.arange(c.ty * c.tx * c.nb)).reshape(-1, c.nb)
    hi = tf32x3.tf32(raw)
    lo = (raw - hi).astype(np.float32)
    # [p/4][n][p%4]
    def slab(a):
        return a.reshape(-1, 4, c.nb).transpose(0, 2, 1).ravel()
    return slab(hi), slab(lo)


def _mm3(a, b_hi, b_lo):
    """3xTF32 as the tensor cores read it: lo truncated to tf32."""
    a_hi = tf32x3.tf32(a)
    a_lo = tf32x3.truncate(a - a_hi)
    b_lo = tf32x3.truncate(b_lo)
    f = np.float32
    return (a_lo @ b_hi).astype(f) + (a_hi @ b_lo).astype(f) + (a_hi @ b_hi).astype(f)


def _emulate_block(x, g, elem, ci0, co0, chunk_range):
    """One block's partial tile (9, 64 or 9 Ci rows, NB) over its chunks."""
    B, H, W, Ci = x.shape
    c = k2.CHUNKING[elem]
    gr = k2.grid(B, H, W, Ci, g.shape[-1], elem)
    fold = gr["fold"]
    L = k2.layout(elem, fold)
    acc = np.zeros((9 * Ci if fold else 9 * 64, c.nb), np.float32)
    for ch in range(*chunk_range):
        b, y0, x0 = k2.chunk_origin(ch, gr["chunks_y"], gr["chunks_x"], elem)
        st = Stage(L, elem)
        _load_stage(st, x, g, b, y0, x0, ci0, co0, L, c, fold, elem)
        if elem == 4:
            hi, lo = _split_g(st, L, c)
        part = np.zeros_like(acc)
        steps = [(s, col) for s in range(c.ty) for col in range(c.tx // c.ks)]
        for s, col in steps:
            p0 = s * c.tx + col * c.ks
            if elem == 2:
                B_ = _b_mn_sw128(st, L["xbytes"] + p0 * 128, 1024, c.ks, c.nb)
            else:
                B_hi = _b_k(hi, (p0 // 4) * c.nb * 16, c.nb * 16, 128, c.ks, c.nb)
                B_lo = _b_k(lo, (p0 // 4) * c.nb * 16, c.nb * 16, 128, c.ks, c.nb)
            if fold:
                A = _a_fold(st, c, Ci, s, col, elem)
                prod = (A @ B_).astype(np.float32) if elem == 2 else _mm3(A, B_hi, B_lo)
                part[:] += prod[:9 * Ci]
                continue
            for kx in range(3):
                for ky in range(3):
                    r = s + ky
                    if elem == 2:
                        prod = (_a_bf16_taps(st, L, c, kx, col, r) @ B_).astype(np.float32)
                    else:
                        prod = _mm3(_a_f32_taps(st, L, c, kx, col, r), B_hi, B_lo)
                    tap = 3 * ky + kx
                    part[tap * 64:(tap + 1) * 64] += prod
        acc += part  # f32: each chunk's sum from zero, then added in f32
    return acc


def _emulate(x, g, elem, sms=132):
    """The whole launch: every block of every split, then the reduction over
    the splits in order."""
    B, H, W, Ci = x.shape
    Co = g.shape[-1]
    c = k2.CHUNKING[elem]
    gr = k2.grid(B, H, W, Ci, Co, elem)
    n_splits = k2.splits(B, H, W, Ci, Co, elem, sms)
    ws = np.zeros((n_splits, 9, Ci, Co), np.float32)
    for s, rng in enumerate(k2.split_chunks(B, H, W, Ci, Co, elem, n_splits)):
        for cb in range(gr["n_ci_blocks"]):
            for nb in range(gr["n_co_blocks"]):
                ci0, co0 = cb * k2.CI_BLOCK, nb * c.nb
                tile = _emulate_block(x, g, elem, ci0, co0, rng)
                n = min(c.nb, Co - co0)
                if gr["fold"]:
                    ws[s, :, :, co0:co0 + n] = tile.reshape(9, Ci, c.nb)[:, :, :n]
                else:
                    m = min(64, Ci - ci0)
                    ws[s, :, ci0:ci0 + m, co0:co0 + n] = tile.reshape(9, 64, c.nb)[:, :m, :n]
    out = np.zeros((9, Ci, Co), np.float32)
    for s in range(n_splits):
        out += ws[s]
    return out.reshape(3, 3, Ci, Co), n_splits


EMU_CASES = [(b, h, w, ci, co) for b, h, w in ((1, 21, 37), (2, 13, 19)) for ci in (1, 3, 16, 24)
             for co in (24, 64)] + [(1, 12, 11, 72, 40)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,H,W,Ci,Co", EMU_CASES)
def test_emulated_data_path_equals_the_plain_version(B, H, W, Ci, Co, dtype):
    rng = np.random.default_rng(B * 1000 + H * 31 + Ci * 7 + Co)
    x = torch.from_numpy(rng.standard_normal((B, H, W, Ci)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((B, H - 2, W - 2, Co)).astype(np.float32)).to(dtype)
    ref = k2.conv3x3_dw_plain(x, g).numpy()
    if dtype == torch.bfloat16:
        xn, gn = (t.view(torch.int16).numpy().view(np.uint16) for t in (x, g))
    else:
        xn, gn = x.numpy(), g.numpy()
    # two blocks a tile on the "card", so that the emulation takes several splits
    gr = k2.grid(B, H, W, Ci, Co, dtype.itemsize)
    got, n_splits = _emulate(xn, gn, dtype.itemsize, sms=2 * gr["n_ci_blocks"] * gr["n_co_blocks"])
    assert n_splits == min(2, gr["n_chunks"])
    err = np.abs(got - ref)
    scale = np.abs(ref).max()
    if dtype == torch.float32:
        assert (err <= 1e-4 * np.abs(ref) + 1e-5 * scale).all(), err.max()
    else:
        assert err.max() <= 2e-2 * scale, err.max()
        # bf16 products are exact in f32: only the sum order differs
        assert err.max() <= 1e-4 * scale, err.max()
