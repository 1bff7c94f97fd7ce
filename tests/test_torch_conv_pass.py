"""The port's conv pass (plain version on the CPU) against the JAX package's
conv pass and its Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellulus_tpu.models import UNetSpec, init_params
from cellulus_tpu.models.unet import _conv_pass
from cellulus_tpu.ops.pallas_conv import conv_pass_2d as jax_conv_pass_2d
from cellulus_tpu_torch.ops.conv_pass import conv_pass_2d
from tests import tf32x3


@pytest.fixture(scope="module")
def small_params():
    spec = UNetSpec(1, 2, 8, 2, 8, ((2, 2),), 2)
    return init_params(jax.random.PRNGKey(0), spec)


def _torch_pass_params(pp):
    return {
        name: {k: torch.from_numpy(np.array(v)) for k, v in conv.items()}
        for name, conv in pp.items()
    }


@pytest.mark.parametrize("level,cin,shape", [
    ("level0", 1, (2, 20, 24)),
    ("level1", 8, (1, 18, 22)),
])
def test_plain_pass_matches_jax(small_params, level, cin, shape):
    pp = small_params["down"][level]
    rng = np.random.default_rng(3)
    x = rng.random((*shape, cin), np.float32)
    got = conv_pass_2d(torch.from_numpy(x), _torch_pass_params(pp), torch.float32)
    c_out = pp["conv0"]["w"].shape[-1]
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (shape[0], shape[1] - 4, shape[2] - 4, c_out)
    ref_xla = np.asarray(_conv_pass(jnp.asarray(x), pp, 2, jnp.float32))
    ref_pallas = np.asarray(jax_conv_pass_2d(jnp.asarray(x), pp, jnp.float32, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref_xla, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref_pallas, atol=1e-5)


@pytest.mark.parametrize("level,cin,shape", [
    ("level0", 1, (2, 20, 24)),
    ("level1", 8, (1, 18, 22)),
])
def test_3xtf32_pass_meets_float32_tolerance(small_params, level, cin, shape):
    """The premise of the kernel's float32 path: each stage's products as
    three TF32 products (bias, ReLU and float32 storage between stages)
    agree with the JAX package's float32 pass, XLA and the Pallas kernel in
    interpret mode, at the float32 bar of test_plain_pass_matches_jax; one
    TF32 product does not."""
    pp = small_params["down"][level]
    x = np.random.default_rng(7).random((*shape, cin), np.float32)
    ref_xla = np.asarray(_conv_pass(jnp.asarray(x), pp, 2, jnp.float32))
    ref_pallas = np.asarray(jax_conv_pass_2d(jnp.asarray(x), pp, jnp.float32, interpret=True))
    got = tf32x3.conv_pass(x, pp)
    np.testing.assert_allclose(got, ref_xla, atol=1e-5)
    np.testing.assert_allclose(got, ref_pallas, atol=1e-5)
    one = tf32x3.conv_pass(x, pp, tf32x3.matmul_1x)
    assert not np.allclose(one, ref_xla, atol=1e-5)


def test_plain_pass_bfloat16_rounds_like_the_kernel(small_params):
    """bf16: each stage sees bf16-rounded inputs and weights and stores a
    bf16 result; the JAX Pallas kernel (interpret mode) has the same
    rounding points, so the two agree to a bf16 ulp of the output scale."""
    pp = small_params["down"]["level1"]
    x = np.random.default_rng(5).random((1, 18, 22, 8), np.float32)
    got = conv_pass_2d(torch.from_numpy(x), _torch_pass_params(pp), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(
        jax_conv_pass_2d(jnp.asarray(x), pp, jnp.bfloat16, interpret=True), np.float32
    )
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2 * np.abs(ref).max())


@pytest.mark.parametrize("bad", ["dtype", "rank", "weights", "device"])
def test_pass_rejects_what_the_kernel_does_not_take(small_params, bad):
    pp = _torch_pass_params(small_params["down"]["level0"])
    x = torch.zeros((1, 12, 12, 1))
    dtype = torch.float32
    if bad == "dtype":
        dtype = torch.float16
    elif bad == "rank":
        x = torch.zeros((12, 12, 1))
    elif bad == "weights":
        x = torch.zeros((1, 12, 12, 3))  # C_in does not match conv0's weights
    else:
        # a non-CPU tensor never takes the plain version: it launches the
        # kernel (CUDA) or raises
        x = torch.zeros((1, 12, 12, 1), device="meta")
    with pytest.raises(ValueError):
        conv_pass_2d(x, pp, dtype)
