"""K1's weight pack (``ops/conv_pass.py`` ``pack_stage``): the layout the
kernel's wgmma reads from its ring, checked on the CPU at the pass shapes
of the example models.

Per n-block of 64 columns the pack holds the stage's K rows in 16-byte slabs
``(n_nb, krows / kin, 64, kin)``: K-major without swizzle, core matrices of
8 columns x 16 bytes, 1024 bytes between k slabs (the descriptor's leading
byte offset) and 128 between 8-column groups (its stride byte offset).
float32 packs hi = tf32(w) and lo = w - hi as two such arrays."""

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
            if c_in % kstep == 0 and c % kstep == 0:
                routes.append("staged")
            for route in routes:
                for i, (kk, ci) in enumerate(((3, c_in), (1, c), (1, c), (3, c))):
                    yield pytest.param(kk, ci, c, dtype, _stage_sbs(route, c, c_in, elem)[i],
                                       id=f"{c_in}->{c}-{route}-stage{i}-{str(dtype)[6:]}")


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


@pytest.mark.parametrize("k,c_in,c,dtype,sb", list(_cases()))
def test_pack_is_a_permutation_with_zero_padding(k, c_in, c, dtype, sb):
    """Unpacking gives the weights back bit for bit; every weight lands in
    exactly one place; everything else in the pack is zero."""
    w = _weights(k, c_in, c, dtype)
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


@pytest.mark.parametrize("k,c_in,c,dtype,sb", list(_cases()))
def test_chunks_and_bytes_equal_the_plan(k, c_in, c, dtype, sb):
    """The pack's size and its chunks are the plan's (stage_geometry, the
    mirror of the kernel's make_stage): each chunk of each n-block is
    contiguous, and read through the wgmma descriptor's addressing (K-major,
    no swizzle, LBO 1024, SBO 128) it gives the stage's K rows."""
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
