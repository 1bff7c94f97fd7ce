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


# The route and tile of every pass at the widths of the repo's 2D TOMLs
# (computed from the source's size and cost formulas; chip_smoke.py holds
# those mirrors against the library on the card). examples/2d keeps the
# tiles it took before the staged route existed.
_EXAMPLE_PLANS = {
    "2d": {
        "down": {"float32": ("fused", 16), "bfloat16": ("fused", 14)},
        "bottom": {"float32": ("fused", 8), "bfloat16": ("fused", 12)},
        "up": {"float32": ("fused", 14), "bfloat16": ("fused", 14)},
    },
    "real-data": {
        "down": {"float32": ("fused", 6), "bfloat16": ("fused", 8)},
        "bottom": {"float32": ("staged", 16), "bfloat16": ("staged", 16)},
        "up": {"float32": ("fused", 14), "bfloat16": ("fused", 14)},
    },
}


@pytest.mark.parametrize("toml", ["2d/infer.toml", "2d/train.toml", "real-data/infer.toml",
                                  "real-data/train.toml"])
def test_plan_of_every_pass_of_the_example_widths(toml):
    from pathlib import Path

    from cellulus_tpu_torch.configs import ExperimentConfig
    from cellulus_tpu_torch.models.geometry import conv_pass_inputs
    from cellulus_tpu_torch.ops.conv_pass import (
        MAX_SHARED_BYTES,
        conv_pass_2d_plan,
        fused_smem_bytes,
        staged_smem_bytes,
    )

    config = ExperimentConfig.from_toml(Path(__file__).resolve().parents[1] / "examples" / toml)
    mc = config.model_config
    stage = config.inference_config if "infer" in toml else config.train_config
    passes = conv_pass_inputs(stage.crop_size, mc.downsampling_factors, 1, mc.num_fmaps,
                              mc.fmap_inc_factor, mc.features_in_last_layer)
    expected = _EXAMPLE_PLANS[toml.split("/")[0]]
    assert [p[0] for p in passes] == list(expected)
    for name, size, c_in, c_out in passes:
        for dtype in (torch.float32, torch.bfloat16):
            plan = conv_pass_2d_plan((128, *size, c_in), c_out, dtype)
            assert plan == expected[name][str(dtype)[6:]], (name, dtype)
            route, tile = plan
            elem = 2 if dtype == torch.bfloat16 else 4
            if route == "fused":
                assert fused_smem_bytes(c_in, c_out, tile, tile, elem) <= MAX_SHARED_BYTES
            else:  # staged only where no fused tile fits
                assert fused_smem_bytes(c_in, c_out, 1, 1, elem) > MAX_SHARED_BYTES
                assert max(staged_smem_bytes(k, ci, tile, tile, elem)
                           for k, ci in ((3, c_in), (1, c_out), (3, c_out))) <= MAX_SHARED_BYTES


def test_a_pass_no_route_takes_raises():
    """Channels that neither fit a fused tile nor stream in the staged
    route's slices raise; the pass is never handed to a library."""
    from cellulus_tpu_torch.ops.conv_pass import conv_pass_2d_plan

    with pytest.raises(ValueError, match="fits no fused tile"):
        conv_pass_2d_plan((1, 64, 64, 256), 776, torch.bfloat16)
    assert conv_pass_2d_plan((1, 64, 64, 256), 784, torch.bfloat16) == ("staged", 16)
