"""K1's weight pack (``ops/conv_pass.py`` ``pack_stage``): the layout the
kernel's wgmma reads from its ring, checked on the CPU at the pass shapes
of the example models.

Per n-block of 64 columns the pack holds the stage's K rows in 16-byte slabs
``(n_nb, krows / kin, 64, kin)``: K-major without swizzle, core matrices of
8 columns x 16 bytes, 1024 bytes between k slabs (the descriptor's leading
byte offset) and 128 between 8-column groups (its stride byte offset).
float32 packs hi = tf32(w) and lo = w - hi as two such arrays.

The bfloat16 staged route (``conv_stage_kernel_persistent<BN>``) reads
another pack (``pack_stage_persistent``): per BN-column n-tile (BN = 256, or
64 where the pass has 64 output channels or fewer) and chunk (one tap x 64
input channels), BN rows of 64 K values in 128 bytes, 16-byte units
swizzled by the row mod 8, read by a K-major 128-byte-swizzle descriptor;
a stage of fewer than 8 input channels (``conv_stage_kernel_first``, on the
CUDA cores) reads the plain weights. The plans (``staged_plan``,
``staged_tile``, ``first_plan``) and the cost model that chooses the route
(``staged_pass_ps``, ``fused_pass_ps``) are held against a g++ build of the
source's "K1 staged plan" lines, and the data paths (TMA boxes, the pack,
both descriptors, the epilogue's swizzled tiles and the clipped TMA stores;
the CUDA-core stage's pixel groups) are emulated in numpy against the
convolution."""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cellulus_tpu_torch.models.geometry import conv_pass_inputs
from cellulus_tpu_torch.ops import conv_pass as k1

NB = k1.NB


def _model_passes(num_fmaps, crop=252):
    """(name, c_in, c_out) of every pass of a 2D model at examples/'s factors."""
    return [(name, c_in, c_out) for name, _, c_in, c_out in conv_pass_inputs(
        (crop, crop), [[2, 2]], 1, num_fmaps, 3, 64)]


# the 64-fmap model of examples/2d, the 256-fmap model of examples/real-data
# and the 24-fmap model of the checkpoint sweep, with 3 input channels too
_PASSES = sorted({(c_in, c_out) for f in (64, 256, 24) for _, c_in, c_out in _model_passes(f)}
                 | {(3, 64), (3, 24)})
_DTYPES = (torch.float32, torch.bfloat16)


def _stage_sbs(route, k, c_in, elem):
    """The streamed channels of each stage of a route (0: not streamed)."""
    if route == "fused":
        first = k1.stream_sb(3, c_in, elem) if k1.fused_streams(c_in, elem) else 0
        return [first, 0, 0, 0]
    return [k1.stream_sb(kk, ci, elem) for kk, ci in ((3, c_in), (1, k), (1, k), (3, k))]


def _cases():
    for c_in, c in _PASSES:
        for dtype in _DTYPES:
            elem = dtype.itemsize
            routes = ["fused"]
            kstep = 16 if elem == 2 else 8
            if (c_in % kstep == 0 and c % kstep == 0) or (elem == 2 and k1.staged_takes(c_in, c)):
                routes.append("staged")
            for route in routes:
                for i, (kk, ci) in enumerate(((3, c_in), (1, c), (1, c), (3, c))):
                    yield pytest.param(kk, ci, c, dtype, _stage_sbs(route, c, c_in, elem)[i],
                                       route,
                                       id=f"{c_in}->{c}-{route}-stage{i}-{str(dtype)[6:]}")


def _persistent(route, dtype):
    """Does this stage take the bf16 staged route's pack?"""
    return route == "staged" and dtype == torch.bfloat16


def _unpack_persistent(packed, k, c_in, c):
    """Inverse of ``pack_stage_persistent``: undo the swizzle, then (n-tile,
    block, tap, n, k) -> (k, k, c_in, c)."""
    n_t, chunks, rows, kk = packed.shape
    n_cb = chunks // (k * k)
    units = packed.reshape(n_t, chunks, rows, 8, 8)
    plain = units[:, :, torch.arange(rows)[:, None], k1.sw128_units(rows)]  # XOR undoes XOR
    w = plain.reshape(n_t, n_cb, k * k, rows, kk).permute(2, 1, 4, 0, 3)
    return w.reshape(k * k, n_cb * kk, n_t * rows)[:, :c_in, :c].reshape(k, k, c_in, c)


def _desc_read(mem, start, rows, ks):
    """What a K-major 128-byte-swizzle wgmma descriptor at element offset
    ``start`` (of a 1024-byte aligned tile) reads for k step ``ks`` (16 K
    values, 32 bytes past the start a step): ``(rows, 16)``. The hardware
    forms the plain address (8-row groups 1024 bytes apart, 128 bytes a
    row) and XORs its bits 4-6 with bits 7-9."""
    r = np.arange(rows)[:, None]
    kk = np.arange(16)[None, :]
    addr = 2 * start + 32 * ks + (r // 8) * 1024 + (r % 8) * 128 + 2 * kk
    addr = addr ^ (((addr >> 7) & 7) << 4)
    return mem[addr // 2]


def _weights(k, c_in, c, dtype, seed=0):
    rng = np.random.default_rng(seed + 7 * c_in + c)
    w = rng.standard_normal((k, k, c_in, c)).astype(np.float32)
    return torch.from_numpy(w).to(dtype)


def _unpack(packed, k, c_in, c, sb=0):
    """Inverse of ``pack_stage`` (float32: from hi + lo)."""
    if packed.dtype == torch.float32:
        packed = packed[0] + packed[1]
    n_nb, slabs, nb, kin = packed.shape
    rows = packed.permute(1, 3, 0, 2).reshape(slabs * kin, n_nb * nb)[:, :c]
    if sb:
        return rows[: k * k * c_in].reshape(c_in // sb, k * k, sb, c).permute(1, 0, 2, 3).reshape(
            k, k, c_in, c)
    cp = k1.cin_pad(c_in, packed.element_size())
    return rows[: k * k * cp].reshape(k * k, cp, c)[:, :c_in].reshape(k, k, c_in, c)


def _k_rows(w, sb, elem):
    """The stage's K rows in the kernel's order, (krows, c): (tap, channel
    padded to 16 bytes), or (block of sb channels, tap, channel); zero rows
    to the pack's row count."""
    k, _, c_in, c = w.shape
    if sb:
        rows = w.reshape(k * k, c_in // sb, sb, c).permute(1, 0, 2, 3).reshape(-1, c)
    else:
        cp = k1.cin_pad(c_in, elem)
        rows = F.pad(w.reshape(k * k, c_in, c), (0, 0, 0, cp - c_in)).reshape(-1, c)
    krows = k1.stage_geometry(k, c_in, 1, 1, elem, sb)["krows"]
    return F.pad(rows, (0, 0, 0, krows - rows.shape[0]))


@pytest.mark.parametrize("k,c_in,c,dtype,sb,route", list(_cases()))
def test_pack_is_a_permutation_with_zero_padding(k, c_in, c, dtype, sb, route):
    """Unpacking gives the weights back bit for bit; every weight lands in
    exactly one place; everything else in the pack is zero (the bf16 staged
    route: its own pack, :func:`pack_stage_persistent`)."""
    w = _weights(k, c_in, c, dtype)
    if _persistent(route, dtype) and c_in % 8:  # the CUDA-core stage reads w as it is
        assert torch.equal(k1.pack_stage_bf16(w), w)
        return
    if _persistent(route, dtype):
        packed = k1.pack_stage_persistent(w)
        assert torch.equal(k1.pack_stage_bf16(w), packed)
        assert packed.dtype == dtype
        assert torch.equal(_unpack_persistent(packed, k, c_in, c), w)
        placed = k1.pack_stage_persistent(torch.ones_like(w)) != 0
        assert int(placed.sum()) == w.numel()
        assert not packed[~placed].any()
        return
    packed = k1.pack_stage(w, sb)
    assert packed.dtype == dtype
    assert torch.equal(_unpack(packed, k, c_in, c, sb), w)
    # where weights go: a pack of ones marks one place per weight; the round
    # trip above shows each weight lands in its own; all else is zero
    hi = packed[0] if dtype == torch.float32 else packed
    ones = k1.pack_stage(torch.ones_like(w))
    placed = (ones[0] if dtype == torch.float32 else ones) != 0
    assert int(placed.sum()) == w.numel()
    assert not hi[~placed].any()
    if dtype == torch.float32:
        assert not packed[1][~placed].any()


@pytest.mark.parametrize("c_in,c", _PASSES)
def test_f32_pack_splits_into_tf32_hi_and_exact_lo(c_in, c):
    """hi + lo == w exactly; hi has its low 13 mantissa bits zero and is w
    rounded to the nearest tf32, ties away from zero, on the bit pattern
    ((bits + 0x1000) & 0xFFFFE000), the kernel's to_tf32."""
    for k, ci in ((3, c_in), (1, c), (3, c)):
        w = _weights(k, ci, c, torch.float32, seed=1)
        hi, lo = k1.pack_stage(w)
        assert torch.equal(hi + lo, k1.pack_stage(w)[0] + k1.pack_stage(w)[1])
        assert torch.equal(_unpack(torch.stack((hi, lo)), k, ci, c), w)
        # the split itself, on the packed values
        full = (hi.double() + lo.double())
        assert torch.equal(full.float().double(), full)  # the sum is exact in float32
        bits = hi.numpy().view(np.uint32)
        assert not (bits & 0x1FFF).any()
        want = ((full.float().numpy().view(np.uint32).astype(np.uint64) + 0x1000)
                & 0xFFFFE000).astype(np.uint32)
        np.testing.assert_array_equal(bits, want)
    # a tie rounds away from zero
    tie = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)])
    np.testing.assert_array_equal(k1._tf32_hi(tie).numpy(), [1.0 + 2.0**-10, -(1.0 + 2.0**-10)])


@pytest.mark.parametrize("k,c_in,c,dtype,sb,route", list(_cases()))
def test_chunks_and_bytes_equal_the_plan(k, c_in, c, dtype, sb, route):
    """The pack's size and its chunks are the plan's (stage_geometry, the
    mirror of the kernel's make_stage): each chunk of each n-block is
    contiguous, and read through the wgmma descriptor's addressing (K-major,
    no swizzle, LBO 1024, SBO 128) it gives the stage's K rows. The bf16
    staged route: ``staged_plan``'s chunks of 32 KB a 256-column n-tile,
    read through the 128-byte-swizzle descriptor four k steps a chunk (8
    KB a tap of a 64-column n-tile where the pass has 64 output channels or
    fewer, a chunk the K taps of a tap row).
    Its CUDA-core stage (fewer than 8 input channels) holds the plain
    weights as f32 in shared memory: ``first_plan``'s bytes."""
    if _persistent(route, dtype) and c_in % 8:
        w = _weights(k, c_in, c, dtype, seed=2)
        assert k1.pack_stage_bf16(w).numel() * 4 == k1.first_plan(1, 1, 1, k, c_in, c)["smem"]
        return
    if _persistent(route, dtype):
        plan = k1.staged_plan(1, 1, 1, k, c_in, c)
        bn = plan["bn"]
        assert bn == (64 if c <= 64 else 256)
        w = _weights(k, c_in, c, dtype, seed=2)
        packed = k1.pack_stage_persistent(w)
        assert packed.numel() * 2 == plan["n_tiles"] * plan["chunks"] * plan["b_bytes"]
        flat = packed.float().reshape(-1).numpy()
        wide = F.pad(w.float(), (0, plan["n_tiles"] * bn - c,
                                 0, plan["n_cb"] * k1.GEMM_K - c_in)).numpy()
        taps = k * k * plan["n_cb"]  # a copy holds plan["taps"] of them, in this order
        for nt in range(plan["n_tiles"]):
            for ch in range(taps):
                cb, tap = divmod(ch, k * k)
                start = (nt * taps + ch) * bn * 64
                want = wide[tap // k, tap % k, cb * 64:(cb + 1) * 64,
                            nt * bn:(nt + 1) * bn].T  # (n, k)
                for ks in range(4):
                    got = _desc_read(flat, start, bn, ks)
                    np.testing.assert_array_equal(got, want[:, 16 * ks:16 * ks + 16])
        return
    elem = dtype.itemsize
    kin = 16 // elem
    g = k1.stage_geometry(k, c_in, 1, 1, elem, sb)
    w = _weights(k, c_in, c, dtype, seed=2)
    packed = k1.pack_stage(w, sb)
    arrays = 2 if dtype == torch.float32 else 1
    n_nb = -(-c // NB)
    assert packed.numel() * elem == arrays * n_nb * g["krows"] * NB * elem
    assert sum(g["chunk_bytes"]) == g["krows"] * NB * elem
    assert len(g["chunk_bytes"]) == g["n_chunks"]
    assert all(b == g["kc"] * NB * elem for b in g["chunk_bytes"][:-1])
    rows = _k_rows(w.float(), sb, elem)  # (krows, c)
    rows = F.pad(rows, (0, n_nb * NB - c))
    flat = (packed[0] if arrays == 2 else packed).float().reshape(-1)
    if arrays == 2:
        flat = flat + packed[1].reshape(-1)
    kstep = 16 // elem * 2  # one wgmma k step: 32 bytes of K
    n = torch.arange(NB)
    for nb in range(n_nb):
        start_row = 0
        for cb in g["chunk_bytes"]:
            chunk = flat[(nb * g["krows"] + start_row) * NB:][: cb // elem]
            k = torch.arange(cb // elem // NB)  # the chunk's rows, k steps in turn
            ks, kk = k // kstep, k % kstep
            byte = (ks[:, None] * 2 * NB * 16 + (kk[:, None] // kin) * 1024
                    + (n[None, :] // 8) * 128 + (n[None, :] % 8) * 16 + (kk[:, None] % kin) * elem)
            want = rows[start_row + k][:, nb * NB:(nb + 1) * NB]
            assert torch.equal(chunk[byte // elem], want)
            start_row += len(k)


@pytest.mark.parametrize("c_in,c,dtype", [(1, 24, torch.float32), (3, 72, torch.bfloat16),
                                          (64, 80, torch.float32), (128, 24, torch.bfloat16)])
def test_stage_gemms_through_the_pack_give_the_convolution(c_in, c, dtype):
    """Each stage as the kernel computes it: A rows decoded from the K order
    (tap, channel padded to 16 bytes, zero rows past K), B the pack, give
    F.conv2d of the stage (float64 arithmetic)."""
    elem = dtype.itemsize
    rng = np.random.default_rng(4)
    for k, ci in ((3, c_in), (1, c)):
        w = _weights(k, ci, c, dtype, seed=3)
        x = torch.from_numpy(rng.random((9, 10, ci)))
        sb = k1.stream_sb(k, ci, elem) if ci % (16 // elem * 2) == 0 and k == 3 else 0
        packed = k1.pack_stage(w, sb).double()
        if dtype == torch.float32:
            packed = packed[0] + packed[1]
        n_nb, slabs, _, kin = packed.shape
        b = packed.permute(1, 3, 0, 2).reshape(slabs * kin, n_nb * NB)  # (krows, cols)
        oh, ow = 10 - k, 11 - k
        cp = sb or k1.cin_pad(ci, elem)
        xp = F.pad(x, (0, cp - ci)) if not sb else x
        a = []
        for kr in range(b.shape[0]):
            if sb:
                j, rem = divmod(kr, k * k * sb)
                tap, ch = divmod(rem, sb)
                ch += j * sb
            else:
                tap, ch = divmod(kr, cp)
                if tap >= k * k:
                    tap, ch = 0, 0  # zero weight rows read pixel 0
            dy, dx = divmod(tap, k)
            a.append(xp[dy:dy + oh, dx:dx + ow, ch].reshape(-1))
        got = (torch.stack(a, 1) @ b)[:, :c].reshape(oh, ow, c)
        want = F.conv2d(x.permute(2, 0, 1)[None], w.double().permute(3, 2, 0, 1))[0]
        torch.testing.assert_close(got, want.permute(1, 2, 0), rtol=1e-12, atol=1e-12)


def test_f32_staged_plan_and_pack_unchanged():
    """float32 keeps the staged kernel of the square tile: its shared bytes
    at the 256-fmap bottom pass's stages (tiles 16 and 8), its streamed
    slices and its pack (``pack_stage`` of those slices) are what they were
    before the bf16 route took its own kernel."""
    stages = ((3, 256), (1, 768), (3, 768))
    assert [k1.staged_smem_bytes(k, ci, t, t, 4) for k, ci in stages for t in (16, 8)] == [
        198784, 136320, 217216, 115840, 198784, 136320]
    assert [k1.stream_sb(k, ci, 4) for k, ci in stages] == [16, 32, 16]
    assert [k1.stage_geometry(k, ci, 16, 16, 4, k1.stream_sb(k, ci, 4))["slot_need"]
            for k, ci in stages] == [43008, 49152, 43008]
    ws = [_weights(k, ci, 48, torch.float32, seed=5) for k, ci in ((3, 32), (1, 48), (1, 48),
                                                                    (3, 48))]
    packed = k1.pack_pass(ws, "staged", 32, 48)
    for w, got in zip(ws, packed):
        k, _, ci, _ = w.shape
        assert torch.equal(got, k1.pack_stage(w, k1.stream_sb(k, ci, 4)))
    # bf16's staged pack is the persistent kernel's
    bf = [w.bfloat16() for w in ws]
    for w, got in zip(bf, k1.pack_pass(bf, "staged", 32, 48)):
        assert torch.equal(got, k1.pack_stage_persistent(w))


# --- the bf16 staged route: plan and data path -----------------------------

SOURCE = k1.__file__.replace("ops/conv_pass.py", "csrc/conv_pass.cu")

_PLAN_MAIN = r"""
#include <cstdio>
int main() {
  int B, oh, ow, K, cin, C;
  while (std::scanf("%d %d %d %d %d %d", &B, &oh, &ow, &K, &cin, &C) == 6) {
    GemmPlan p = gemm_plan(B, oh, ow, K, cin, C);
    int img, y0, x0, nt;
    gemm_tile(p, p.tiles - 1, img, y0, x0, nt);
    int img2, y2, x2, nt2;
    gemm_tile(p, p.tiles / 3, img2, y2, x2, nt2);
    FirstPlan f = first_plan(B, oh, ow, K, cin, C);
    std::printf("%d %d %d %d %d %d %lld %d %lld %d %d %d %d %d %d %d %d %lld %d %d %d %d %d %d "
                "%d %d %d %d %lld %lld %d %lld %lld %lld\n", p.bm, p.bn, p.bh, p.bw,
                p.tiles_y, p.tiles_x, p.m_tiles, p.n_tiles, p.tiles, p.n_cb, p.chunks, p.taps,
                p.box_w, p.a_tx, p.a_bytes, p.b_bytes, p.slots, p.smem, img, y0, x0, nt, img2,
                y2, x2, nt2, f.groups, f.per_block, f.items,
                f.smem, (int)staged_takes(cin, C), staged_stage_ps(B, oh + K - 1, ow + K - 1, K,
                cin, C), staged_pass_ps(B, oh + 4, ow + 4, cin, C),
                fused_pass_ps(B, 1234567LL + C));
  }
}
"""

_PLAN_KEYS = ("bm", "bn", "bh", "bw", "tiles_y", "tiles_x", "m_tiles", "n_tiles", "tiles",
              "n_cb", "chunks", "taps", "box_w", "a_tx", "a_bytes", "b_bytes", "slots", "smem")


def _staged_plan_cases():
    # the 256-fmap bottom pass's four stages at the cell's and [K1-wide]'s
    # tile batches, then random shapes the route takes (channels % 16)
    cases = [(B, 122, 122, 3, 256, 768) for B in (1, 16, 128)]
    cases += [(B, 122, 122, 1, 768, 768) for B in (1, 16, 128)]
    cases += [(B, 120, 120, 3, 768, 768) for B in (1, 16, 128)]
    rng = np.random.default_rng(19)
    for _ in range(60):
        cases.append((int(rng.integers(1, 9)), int(rng.integers(1, 300)),
                      int(rng.integers(1, 300)), int(rng.choice([1, 3])),
                      16 * int(rng.integers(1, 80)), 16 * int(rng.integers(1, 300))))
    # the 256-fmap down and up passes' stages and the 64-fmap model's, at
    # both tile batches, then random narrow shapes: 64 output channels or
    # fewer, inputs of fewer than 8 channels
    for B in (16, 128):
        cases += [(B, 250, 250, 3, 1, 256), (B, 250, 250, 1, 256, 256),
                  (B, 248, 248, 3, 256, 256), (B, 238, 238, 3, 1024, 64),
                  (B, 238, 238, 1, 64, 64), (B, 236, 236, 3, 64, 64),
                  (B, 250, 250, 3, 1, 64), (B, 122, 122, 3, 64, 192),
                  (B, 238, 238, 3, 256, 64)]
    for _ in range(40):
        cases.append((int(rng.integers(1, 9)), int(rng.integers(1, 300)),
                      int(rng.integers(1, 300)), int(rng.choice([1, 3])),
                      int(rng.choice([1, 2, 3, 5, 8, 24, 64, 136])),
                      8 * int(rng.integers(1, 9))))
    return cases


@pytest.fixture(scope="module")
def staged_plan_binary(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the source's plan formulas")
    src = open(SOURCE).read()
    body = re.search(r"// ---- K1 staged plan begin.*?\n(.*)// ---- K1 staged plan end", src,
                     re.S).group(1)
    d = tmp_path_factory.mktemp("k1plan")
    (d / "plan.cpp").write_text("#define __host__\n#define __device__\n" + body + _PLAN_MAIN)
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(d / "plan"), str(d / "plan.cpp")],
                   check=True, capture_output=True, text=True)
    cases = _staged_plan_cases()
    out = subprocess.run([str(d / "plan")], input="\n".join(" ".join(map(str, c)) for c in cases),
                         capture_output=True, text=True, check=True).stdout.split("\n")
    return {c: [int(v) for v in line.split()] for c, line in zip(cases, out)}


def test_staged_plan_mirror_equals_the_source(staged_plan_binary):
    """``staged_plan``, ``staged_tile`` (the last tile and one a third of
    the way through the walk), ``first_plan``, ``staged_takes`` and the
    cost model (``staged_stage_ps``, ``staged_pass_ps``, ``fused_pass_ps``)
    against a g++ build of the source's lines."""
    assert len(staged_plan_binary) > 100
    for c, got in staged_plan_binary.items():
        B, oh, ow, k, c_in, ch = c
        plan = k1.staged_plan(*c)
        want = [plan[key] for key in _PLAN_KEYS]
        want += [*k1.staged_tile(plan, plan["tiles"] - 1), *k1.staged_tile(plan, plan["tiles"] // 3)]
        f = k1.first_plan(*c)
        want += [f["groups"], f["per_block"], f["items"], f["smem"], int(k1.staged_takes(c_in, ch)),
                 k1.staged_stage_ps(B, oh + k - 1, ow + k - 1, k, c_in, ch),
                 k1.staged_pass_ps(B, oh + 4, ow + 4, c_in, ch),
                 k1.fused_pass_ps(B, 1234567 + ch)]
        assert got == want, c


@pytest.mark.parametrize("B,oh,ow,k,c_in,c", _staged_plan_cases()[:9] + [
    (1, 62, 62, 3, 256, 4640), (2, 11, 11, 3, 80, 304), (1, 3, 122, 1, 64, 256),
    (16, 238, 238, 3, 1024, 64), (2, 11, 11, 3, 80, 48), (1, 1, 256, 1, 16, 64),
    (3, 37, 300, 3, 8, 24)])
def test_staged_plan_formulas(B, oh, ow, k, c_in, c):
    """The plan against its formulas: the tile is 128 pixels x 256 channels,
    or two rows of 128 pixels x 64 channels where the stage has 64 output
    channels or fewer; the ring's slots of A (one TMA box of the tile's
    pixels x 64 channels; at 64 columns k - 1 pixels wider, for a tap row's
    k taps) and B (the tile's columns x 64 K a tap) fill what the output
    tile, the barriers and the alignment slack leave of 227 KB; the box pads
    the grid least; the walk's tiles cover every (image, box, n-tile)
    once."""
    p = k1.staged_plan(B, oh, ow, k, c_in, c)
    bm, bn = p["bm"], p["bn"]
    assert (bm, bn) == ((256, 64) if c <= 64 else (128, 256))
    taps = k if bn == 64 else 1
    assert (p["taps"], p["box_w"]) == (taps, p["bw"] + taps - 1)
    assert p["a_tx"] == p["bh"] * p["box_w"] * 128 and p["b_bytes"] == taps * bn * 128
    assert p["a_bytes"] % 1024 == 0 and 0 <= p["a_bytes"] - p["a_tx"] < 1024
    slot = p["a_bytes"] + p["b_bytes"]
    assert (p["slots"], p["smem"]) == {
        (256, 1): (3, 1024 + 65536 + 128 + 3 * 49152),
        (64, 1): (4, 1024 + 32768 + 128 + 4 * 40960),
        (64, 3): (3, 1024 + 32768 + 128 + 3 * (33792 + 24576))}[(bn, taps)]
    assert p["smem"] <= k1.MAX_SHARED_BYTES < p["smem"] + slot
    assert p["bh"] * p["bw"] == bm and p["bh"] in (1, 2, 4, 8)
    area = p["tiles_y"] * p["bh"] * p["tiles_x"] * p["bw"]
    if bn == 64:
        assert (p["bh"], p["bw"]) == (2, 128)
    else:
        assert all(area <= -(-oh // h) * h * -(-ow // (bm // h)) * (bm // h)
                   for h in (1, 2, 4, 8))
    assert p["tiles_y"] * p["bh"] >= oh > (p["tiles_y"] - 1) * p["bh"]
    assert p["tiles_x"] * p["bw"] >= ow > (p["tiles_x"] - 1) * p["bw"]
    assert p["m_tiles"] == B * p["tiles_y"] * p["tiles_x"]
    assert p["n_tiles"] == -(-c // bn) and p["tiles"] == p["m_tiles"] * p["n_tiles"]
    assert p["n_cb"] == -(-c_in // 64) and p["chunks"] * taps == k * k * p["n_cb"]
    if p["tiles"] <= 2000:
        seen = {k1.staged_tile(p, t) for t in range(p["tiles"])}
        assert len(seen) == p["tiles"]
        assert {s[3] for s in seen} == set(range(p["n_tiles"]))
        assert max(s[0] for s in seen) == B - 1
        # the boxes of one n-tile cover every output pixel exactly once
        hits = np.zeros((B, p["tiles_y"] * p["bh"], p["tiles_x"] * p["bw"]), int)
        for img, y0, x0, nt in seen:
            if nt == 0:
                hits[img, y0:y0 + p["bh"], x0:x0 + p["bw"]] += 1
        assert (hits == 1).all()


def test_staged_tiles_counts_the_four_stages():
    """``k1.staged_tiles`` of the 256-fmap bottom pass (tile batch 16): three
    stages on the 122^2 grid and one on 120^2, one 1 x 128 box a row, three
    n-tiles of 768 columns. The down pass: its first stage's pixels on the
    CUDA cores (``k1.first_pixels``), then two 1 x 128 boxes a row; the up
    pass: 64-column tiles of two rows of 128 (``k1.staged_tiles_n64``)."""
    work = k1.staged_work((16, 124, 124, 256), 768)
    assert work == {"k1.staged_tiles": 3 * 16 * 122 * 3 + 16 * 120 * 3}
    assert work["k1.staged_tiles"] == sum(
        k1.staged_plan(16, s, s, k, ci, 768)["tiles"]
        for s, k, ci in ((122, 3, 256), (122, 1, 768), (122, 1, 768), (120, 3, 768)))
    assert k1.staged_work((16, 252, 252, 1), 256) == {
        "k1.first_pixels": 16 * 250 * 250, "k1.staged_tiles": 2 * 16 * 250 * 2 + 16 * 248 * 2}
    assert k1.staged_work((16, 240, 240, 1024), 64) == {
        "k1.staged_tiles_n64": 3 * 16 * 119 * 2 + 16 * 118 * 2}


def _sw_tile(box):
    """A TMA box of 128-byte rows (rows, 64 bf16 values) laid out with the
    128-byte swizzle: element (r, e) at r * 64 + ((e // 8) ^ (r % 8)) * 8 + e % 8."""
    rows = box.shape[0]
    out = np.zeros(rows * 64, box.dtype)
    r = np.arange(rows)[:, None]
    e = np.arange(64)[None, :]
    out[r * 64 + ((e // 8) ^ (r % 8)) * 8 + e % 8] = box
    return out


def _tma_box(a, img, y0, x0, c0, bh, bw, bc):
    """The TMA box (bh, bw, bc) of NHWC ``a`` at (c0, x0, y0, img), zeros
    where it leaves the tensor."""
    out = np.zeros((bh, bw, bc), a.dtype)
    h = max(0, min(bh, a.shape[1] - y0))
    w = max(0, min(bw, a.shape[2] - x0))
    ch = max(0, min(bc, a.shape[3] - c0))
    out[:h, :w, :ch] = a[img, y0:y0 + h, x0:x0 + w, c0:c0 + ch]
    return out


def _emulate_persistent_stage(x, w, b):
    """The persistent kernel's data path in float64 on bf16 values: for each
    tile of the walk and each chunk, the slot's input (the tap-shifted TMA
    box of the tile's ``bm`` pixels, swizzled) and weights (the pack's chunk
    of ``bn`` columns), each warpgroup's four k steps on its ``bm / 2``
    pixels read through the descriptors (the weights as B at 256 columns,
    as A at 64); then the epilogue (bias, ReLU, bf16) into the warpgroup's
    swizzled 64-pixel x 64-channel tiles and the TMA stores of those boxes,
    clipped at the output's edge."""
    B, H, W, c_in = x.shape
    k, c = w.shape[0], w.shape[-1]
    oh, ow = H - k + 1, W - k + 1
    p = k1.staged_plan(B, oh, ow, k, c_in, c)
    bm, bn = p["bm"], p["bn"]
    mt, ns = bm // 128, bn // 64
    packed = k1.pack_stage_persistent(w).float().reshape(-1).numpy().astype(np.float64)
    assert packed.size * 2 == p["n_tiles"] * p["chunks"] * p["b_bytes"]
    xs = x.float().numpy().astype(np.float64)
    bias = b.float().numpy().astype(np.float64)
    out = np.full((B, oh, ow, c), np.nan)
    sw = min(p["bw"], 64)
    for t in range(p["tiles"]):
        img, y0, x0, nt = k1.staged_tile(p, t)
        acc = np.zeros((2, bm // 2, bn))  # a warpgroup's pixels x columns
        for ch in range(p["chunks"]):
            if bn == 256:  # 64 channels at one tap
                cb, tap = divmod(ch, k * k)
                dy, dx = divmod(tap, k)
            else:  # 64 channels at one tap row: the box k - 1 pixels wider
                (cb, dy), dx = divmod(ch, k), 0
            box = _tma_box(xs, img, y0 + dy, x0 + dx, 64 * cb, p["bh"], p["box_w"], 64)
            assert box.size * 2 == p["a_tx"]
            room = np.zeros(p["a_bytes"] // 2)
            room[:box.size] = _sw_tile(box.reshape(-1, 64))
            weights = packed[(nt * p["chunks"] + ch) * p["b_bytes"] // 2:][:p["b_bytes"] // 2]
            slot = np.concatenate([room, weights])
            for wg in range(2):
                for ks in range(4):
                    if bn == 256:  # m64n256k16: the pixels as A, the weights as B
                        wmat = _desc_read(slot, p["a_bytes"] // 2, bn, ks)  # (256 columns, 16)
                        xmat = _desc_read(slot, wg * 64 * 64, 64, ks)      # (64 pixels, 16)
                        acc[wg] += xmat @ wmat.T
                        continue
                    for t in range(p["taps"]):  # m64n128k16: the weights as A, the pixels as B
                        wmat = _desc_read(slot, p["a_bytes"] // 2 + t * 64 * 64, 64, ks)
                        # the warpgroup's row of the box from pixel t on: a
                        # start inside the swizzle's 8-row period
                        xmat = _desc_read(slot, (wg * p["box_w"] + t) * 64, 128, ks)
                        acc[wg] += (wmat @ xmat.T).T
        cols = nt * bn + np.arange(bn)
        bcol = np.where(cols < c, bias[np.minimum(cols, c - 1)], 0.0)
        for wg in range(2):
            for mi in range(mt):
                v = np.maximum(acc[wg, 64 * mi:64 * mi + 64] + bcol, 0.0)
                v = torch.from_numpy(v).to(torch.bfloat16)
                v = v.double().numpy()
                staging = np.zeros(ns * 4096)
                q = np.arange(64)[:, None]
                col = np.arange(bn)[None, :]
                staging[(col // 64) * 4096 + q * 64 + (((col % 64) // 8) ^ (q % 8)) * 8
                        + col % 8] = v
                i = wg * mt + mi
                sx = (64 * i) % p["bw"] if p["bw"] >= 64 else 0
                sy = (64 * i) // p["bw"] if p["bw"] >= 64 else i * (64 // sw)
                for s in range(ns):
                    c0 = nt * bn + 64 * s
                    if c0 >= c:
                        continue
                    sub = staging[s * 4096:(s + 1) * 4096]
                    qq = np.arange(64)[:, None]
                    e = np.arange(64)[None, :]
                    tile = sub[qq * 64 + ((e // 8) ^ (qq % 8)) * 8 + e % 8]  # (pixel, channel)
                    for j in range(64):
                        yy, xx = y0 + sy + j // sw, x0 + sx + j % sw
                        if yy < oh and xx < ow:
                            n = min(64, c - c0)
                            assert np.isnan(out[img, yy, xx, c0:c0 + n]).all()  # stored once
                            out[img, yy, xx, c0:c0 + n] = tile[j, :n]
    return out, p


@pytest.mark.parametrize("B,H,W,k,c_in,c", [
    (2, 13, 13, 3, 80, 304),     # 8 x 16 boxes, a partial channel block and n-tile
    (1, 3, 124, 1, 64, 256),     # 1 x 128 boxes, a 1 x 1 stage
    (1, 37, 62, 3, 64, 96),      # 2 x 64 boxes clipped at the right and bottom edge
    (2, 13, 13, 3, 80, 48),      # 64-column tiles, clipped: 48 of 64 columns stored
    (1, 2, 128, 1, 16, 64),      # 64-column tiles: one 2 x 128 box, 16 of 64 channels read
    (1, 7, 133, 3, 136, 40),     # 64-column tiles clipped at both edges, three channel blocks
])
def test_persistent_stage_data_path_gives_the_convolution(B, H, W, k, c_in, c):
    """The emulated data path of ``conv_stage_kernel_persistent<BN>`` writes
    every output element once, and gives the stage (convolution of the bf16
    values in float64, f32 bias, ReLU, one rounding to bf16) up to the bf16
    rounding of sums taken in another order."""
    rng = np.random.default_rng(B + H + k + c)
    x = torch.from_numpy(rng.standard_normal((B, H, W, c_in)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((k, k, c_in, c)).astype(np.float32)
                         / np.sqrt(k * k * c_in)).bfloat16()
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1)
    got, p = _emulate_persistent_stage(x, w, b)
    assert not np.isnan(got).any()
    ref = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
                   b.double()).relu().to(torch.bfloat16).double().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6)
    assert {(1, 3, 124): (1, 128), (2, 13, 13): (8, 16) if c > 64 else (2, 128),
            (1, 37, 62): (2, 64), (1, 2, 128): (2, 128), (1, 7, 133): (2, 128)}[(B, H, W)] == (
        p["bh"], p["bw"])


def _emulate_first_stage(x, w, b, grid):
    """``conv_stage_kernel_first``'s data path on ``grid`` blocks, in
    float32 as the kernel computes it: each block's pixel groups in the
    grid-stride walk (``first_plan``), a thread's 4 pixels x
    8 channels summed in the order (dy, channel, dx) (a bf16 x bf16 product
    is exact in float32, so each fmaf is one rounding of the sum), the f32
    bias, ReLU, one rounding to bf16; pixels past the row read its last
    input pixel and are not stored."""
    B, H, W, c_in = x.shape
    k, c = w.shape[0], w.shape[-1]
    oh, ow = H - k + 1, W - k + 1
    p = k1.first_plan(B, oh, ow, k, c_in, c)
    xs, ws, bs = x.float().numpy(), w.float().numpy(), b.float().numpy()
    out = np.full((B, oh, ow, c), np.nan, np.float32)
    for blk in range(grid):
        for pg in range(p["per_block"]):
            it = blk * p["per_block"] + pg
            while it < p["items"]:
                # the kernel's decode of pixel group it: (image, row, x0)
                r, xq = divmod(it, -(-ow // k1.FIRST_PIX))
                (img, y), x0 = divmod(r, oh), xq * k1.FIRST_PIX
                acc = np.zeros((k1.FIRST_PIX, c), np.float32)
                for dy in range(k):
                    for ci in range(c_in):
                        for dx in range(k):
                            for q in range(k1.FIRST_PIX):
                                v = xs[img, y + dy, min(x0 + q + dx, W - 1), ci]
                                acc[q] = acc[q] + v * ws[dy, dx, ci]
                for q in range(k1.FIRST_PIX):
                    if x0 + q < ow:
                        assert np.isnan(out[img, y, x0 + q]).all()  # each pixel once
                        v = torch.from_numpy(np.maximum(acc[q] + bs, np.float32(0)))
                        out[img, y, x0 + q] = v.bfloat16().float().numpy()
                it += grid * p["per_block"]
    return out, p


@pytest.mark.parametrize("B,H,W,c_in,c,grid", [
    (2, 9, 11, 1, 256, 3),    # the 256-fmap first stage's widths: a warp a pixel group
    (1, 12, 13, 3, 64, 2),    # three input channels, 64 outputs: a ragged last group
    (2, 7, 10, 5, 24, 1),     # 24 outputs (3 groups of 8): 85 pixel groups a block
])
def test_first_stage_covers_every_pixel_once_and_gives_the_convolution(B, H, W, c_in, c, grid):
    """The CUDA-core stage of the bf16 staged route (fewer than 8 input
    channels): its blocks' pixel groups cover every output pixel exactly
    once, and give the stage up to the bf16 rounding of sums taken in
    another order."""
    rng = np.random.default_rng(H * W + c)
    x = torch.from_numpy(rng.random((B, H, W, c_in)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((3, 3, c_in, c)).astype(np.float32)
                         / np.sqrt(9 * c_in)).bfloat16()
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1)
    got, p = _emulate_first_stage(x, w, b, grid)
    assert not np.isnan(got).any()
    assert p["groups"] * p["per_block"] <= k1.FIRST_THREADS and p["per_block"] >= 1
    assert p["smem"] == 4 * w.numel() == 4 * k1.pack_stage_bf16(w).numel()
    ref = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
                   b.double()).relu().to(torch.bfloat16).double().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6)
