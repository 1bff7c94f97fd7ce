"""K2, the 3x3 filter gradient: the port's plain version (CPU) against the
JAX package's Pallas kernel (interpret mode), its numpy oracle and
``jax.grad``; ``Conv3x3Valid`` against ``jax.vjp`` of ``conv_valid_pallas``
and of the plain conv."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellulus_tpu.models.unet import _dimension_numbers
from cellulus_tpu.ops.conv_vjp import conv_valid_pallas
from cellulus_tpu.ops.pallas_dw import _np_reference_dw, conv3x3_dw as jax_conv3x3_dw
from cellulus_tpu_torch.ops.conv_dw import conv3x3_dw, conv3x3_dw_plain
from cellulus_tpu_torch.ops.conv_vjp import conv3x3_valid
from tests import tf32x3

SHAPES = [
    (2, 12, 14, 1, 8),   # Ci = 1, the first conv of the down pass
    (1, 13, 11, 6, 10),  # odd H and W, Ci != Co
    (2, 16, 16, 8, 8),
]


def _jax_conv(x, w):
    return jax.lax.conv_general_dilated(
        x, w, (1, 1), "VALID", dimension_numbers=_dimension_numbers(2)
    )


def _inputs(B, H, W, Ci, Co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, Ci)).astype(np.float32)
    g = rng.standard_normal((B, H - 2, W - 2, Co)).astype(np.float32)
    return x, g


@pytest.mark.parametrize("B,H,W,Ci,Co", SHAPES)
def test_plain_matches_pallas_kernel_on_bf16_inputs(B, H, W, Ci, Co):
    """The TPU kernel computes in bf16: on bf16-quantized inputs the port's
    f32 plain version agrees to the bar of tests/test_pallas_dw.py
    (rtol 2e-2, atol 2e-2)."""
    x, g = _inputs(B, H, W, Ci, Co)
    xq = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    gq = np.asarray(jnp.asarray(g, jnp.bfloat16), np.float32)
    want = np.asarray(jax_conv3x3_dw(jnp.asarray(xq), jnp.asarray(gq), interpret=True))
    got = conv3x3_dw(
        torch.from_numpy(xq).to(torch.bfloat16), torch.from_numpy(gq).to(torch.bfloat16)
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 3, Ci, Co)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("B,H,W,Ci,Co", SHAPES)
def test_plain_float32_matches_oracle_and_jax_grad(B, H, W, Ci, Co):
    """Float32 inputs stay float32 (no bf16 rounding): rtol 1e-5 against the
    numpy oracle and against XLA's f32 filter gradient (atol 1e-5 x the
    largest entry, for entries that cancel to near zero)."""
    x, g = _inputs(B, H, W, Ci, Co, seed=1)
    got = conv3x3_dw_plain(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    scale = np.abs(got).max()
    np.testing.assert_allclose(got, _np_reference_dw(x, g), rtol=1e-5, atol=1e-5 * scale)
    w0 = jnp.zeros((3, 3, Ci, Co), jnp.float32)
    want = jax.grad(lambda w: (_jax_conv(jnp.asarray(x), w) * jnp.asarray(g)).sum())(w0)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5 * scale)


def test_tf32_split_keeps_21_bits():
    """The split of the kernels' float32 path: hi and lo as the tensor core
    reads them are TF32 values (low 13 bits zero), |a - hi| is at most half
    a TF32 ulp (2^-11 relative), and hi + lo is a to 2^-21 relative; hi
    rounds ties away from zero."""
    rng = np.random.default_rng(4)
    a = (rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))).astype(np.float32)
    hi, lo = tf32x3.split(a)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert (np.abs(hi.astype(np.float64) - a) / np.abs(a)).max() <= 2.0**-11
    rel = np.abs((hi.astype(np.float64) + lo) - a) / np.abs(a)
    assert rel.max() <= 2.0**-21
    # ties away from zero: 1 + 2^-11 lies halfway between two TF32 values
    tie = np.array([1 + 2.0**-11, -(1 + 2.0**-11)], np.float32)
    np.testing.assert_array_equal(tf32x3.tf32(tie), [1 + 2.0**-10, -(1 + 2.0**-10)])


@pytest.mark.parametrize("B,H,W,Ci,Co", SHAPES)
def test_3xtf32_filter_gradient_meets_float32_tolerance(B, H, W, Ci, Co):
    """The premise of the kernel's float32 path: three TF32 products per
    float32 product agree with XLA's float32 filter gradient (jax.vjp) at the
    float32 bar of test_plain_float32_matches_oracle_and_jax_grad; one TF32
    product does not."""
    x, g = _inputs(B, H, W, Ci, Co, seed=5)
    w0 = jnp.zeros((3, 3, Ci, Co), jnp.float32)
    _, vjp = jax.vjp(lambda w: _jax_conv(jnp.asarray(x), w), w0)
    want = np.asarray(vjp(jnp.asarray(g))[0])
    scale = np.abs(want).max()
    np.testing.assert_allclose(tf32x3.conv3x3_dw(x, g), want, rtol=1e-5, atol=1e-5 * scale)
    one = tf32x3.conv3x3_dw(x, g, tf32x3.matmul_1x)
    assert not np.allclose(one, want, rtol=1e-5, atol=1e-5 * scale)


def test_wrapper_checks_its_inputs():
    x = torch.zeros(1, 8, 8, 2)
    with pytest.raises(ValueError, match="H-2"):
        conv3x3_dw(x, torch.zeros(1, 5, 6, 3))
    with pytest.raises(ValueError, match="float32 or both bfloat16"):
        conv3x3_dw(x, torch.zeros(1, 6, 6, 3, dtype=torch.bfloat16))


def _vjp_case(dtype_np, seed=2, B=2, H=14, W=12, Ci=4, Co=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, Ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, Ci, Co)) * 0.3).astype(np.float32)
    b = rng.standard_normal(Co).astype(np.float32)
    g = rng.standard_normal((B, H - 2, W - 2, Co)).astype(np.float32)
    return x, w, b, g


def _port_vjp(x, w, b, g, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    w_param = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).requires_grad_()
    b_param = torch.from_numpy(b).requires_grad_()
    out = conv3x3_valid(xt, w_param.to(dtype)) + b_param.to(dtype)
    out.backward(torch.from_numpy(g).to(dtype))
    return (
        out.detach().float().numpy(),
        xt.grad.float().numpy(),
        w_param.grad.permute(2, 3, 1, 0).numpy(),  # back to (3, 3, Ci, Co)
        b_param.grad.numpy(),
    )


def _jax_vjp(conv, x, w, b, g, dtype):
    def f(x_, w_, b_):
        return conv(x_.astype(dtype), w_.astype(dtype)) + b_.astype(dtype)

    out, vjp = jax.vjp(f, jnp.asarray(x, dtype), jnp.asarray(w), jnp.asarray(b))
    dx, dw, db = vjp(jnp.asarray(g, dtype))
    return [np.asarray(a, np.float32) for a in (out, dx, dw, db)]


def test_conv3x3_valid_float32_matches_jax_vjp():
    """f32: forward, dx, dw and db against jax.vjp of the plain conv at
    rtol 1e-5 (atol 1e-5 x max); against conv_valid_pallas, whose dw runs
    the TPU kernel's bf16 arithmetic (interpret mode), dw at rtol 2e-2."""
    x, w, b, g = _vjp_case(np.float32)
    mine = _port_vjp(x, w, b, g, torch.float32)
    plain = _jax_vjp(lambda a, k: _jax_conv(a, k), x, w, b, g, jnp.float32)
    pallas = _jax_vjp(lambda a, k: conv_valid_pallas(a, k, 2), x, w, b, g, jnp.float32)
    for name, m, p in zip(("out", "dx", "dw", "db"), mine, plain):
        np.testing.assert_allclose(m, p, rtol=1e-5, atol=1e-5 * np.abs(p).max(), err_msg=name)
    for name, m, p in zip(("out", "dx", "db"), (mine[0], mine[1], mine[3]),
                          (pallas[0], pallas[1], pallas[3])):
        np.testing.assert_allclose(m, p, rtol=1e-5, atol=1e-5 * np.abs(p).max(), err_msg=name)
    np.testing.assert_allclose(mine[2], pallas[2], rtol=2e-2, atol=2e-2 * np.abs(pallas[2]).max())


def test_conv3x3_valid_bfloat16_matches_jax_vjp():
    """bf16: both frameworks round the conv output, the bias sum and the
    gradients to bf16 at the same points, but sum in different orders, so
    each agrees to 2e-2 x its largest entry; dw is K2's f32 sum rounded to
    bf16, as conv_valid_pallas's ``.astype(w.dtype)``."""
    x, w, b, g = _vjp_case(np.float32, seed=3)
    mine = _port_vjp(x, w, b, g, torch.bfloat16)
    for conv in (lambda a, k: _jax_conv(a, k), lambda a, k: conv_valid_pallas(a, k, 2)):
        ref = _jax_vjp(conv, x, w, b, g, jnp.bfloat16)
        for name, m, r in zip(("out", "dx", "dw", "db"), mine, ref):
            np.testing.assert_allclose(m, r, atol=2e-2 * np.abs(r).max(), err_msg=name)
