"""The port's U-Net and TTA (CPU) against the JAX package's, on the same
weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellulus_tpu.models import UNetSpec, forward, init_params, tta_embeddings as jax_tta
from cellulus_tpu.models.torch_export import save_torch_checkpoint
from tests.unet_pairs import unet_pair
from cellulus_tpu_torch.models import (
    UNet,
    load_checkpoint,
    state_dict_from_jax_params,
    tta_embeddings,
)


def _pair(factors=((2, 2),), num_fmaps=8, inc=2, fil=16):
    spec = UNetSpec(1, 2, num_fmaps, inc, fil, tuple(factors), 2)
    params = init_params(jax.random.PRNGKey(0), spec)
    model = UNet(1, 2, num_fmaps, inc, fil, [list(f) for f in factors], 2)
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return spec, params, model.eval()


@pytest.mark.parametrize("factors,size", [(((2, 2),), 60), (((2, 2), (2, 2)), 76)])
def test_forward_matches_jax(factors, size):
    spec, params, model = _pair(factors)
    x = np.random.default_rng(0).normal(size=(2, size, size, 1)).astype(np.float32)
    with torch.no_grad():
        mine = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(forward(spec, params, jnp.asarray(x)))
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, atol=2e-4, rtol=1e-4)


def test_pth_from_jax_export_loads_the_same_weights(tmp_path):
    spec, params, model = _pair(((2, 2), (2, 2)))
    path = tmp_path / "export.pth"
    save_torch_checkpoint(path, params, iteration=7, lowest_loss=0.5)
    loaded = UNet(1, 2, 8, 2, 16, [[2, 2], [2, 2]], 2)
    state = load_checkpoint(path, loaded)
    assert state["iteration"] == 7
    for (k, a), (k2, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_load_checkpoint_refuses_jax_ckpt(tmp_path):
    """A JAX-package .ckpt cut short is refused with the JAX package's
    wording (a whole one loads: tests/test_torch_ckpt.py)."""
    from cellulus_tpu.utils.checkpoint import save_checkpoint

    spec, params, _ = _pair()
    path = tmp_path / "best_loss.ckpt"
    save_checkpoint(path, {"iteration": 0, "lowest_loss": 1.0, "params": params})
    path.write_bytes(path.read_bytes()[:-100])
    with pytest.raises(ValueError, match="corrupt or truncated checkpoint"):
        load_checkpoint(path, UNet(1, 2, 8, 2, 16, [[2, 2]], 2))


def test_tta_without_noise_matches_jax():
    spec, params, model = _pair()
    tile = np.random.default_rng(1).random((44, 44, 1)).astype(np.float32)
    nii = 2
    ref = np.asarray(jax_tta(spec, params, jnp.asarray(tile), jax.random.PRNGKey(0), 0.0, nii))
    uniform = torch.rand((2 * nii, 1, 44, 44, 1), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        mine = tta_embeddings(model, torch.from_numpy(tile)[None], uniform, 0.0, nii)[0]
    np.testing.assert_allclose(mine.numpy(), ref, atol=2e-4, rtol=1e-4)


def test_tta_with_noise_matches_jax_forward_on_the_same_draws():
    """The frameworks' RNGs differ, so one numpy draw feeds both: the port's
    TTA against a JAX forward of the same noisy copies + mean / std."""
    spec, params, model = _pair()
    rng = np.random.default_rng(2)
    tiles = rng.random((2, 44, 44, 1)).astype(np.float32)
    nii, p = 2, 0.05
    uniform = rng.random((2 * nii, *tiles.shape)).astype(np.float32)
    with torch.no_grad():
        mine = tta_embeddings(
            model, torch.from_numpy(tiles), torch.from_numpy(uniform), p, nii
        ).numpy()

    vals = np.array([0.5] * nii + [1.0] * nii, np.float32).reshape(-1, 1, 1, 1, 1)
    noisy = np.where(uniform <= p, vals, tiles[None])
    preds = np.asarray(forward(spec, params, jnp.asarray(noisy.reshape(-1, 44, 44, 1))))
    preds = preds.reshape(2 * nii, 2, *preds.shape[1:])
    ref = np.concatenate(
        [preds.mean(0), preds.std(0).sum(-1, keepdims=True)], axis=-1
    )
    assert (uniform <= p).any()
    np.testing.assert_allclose(mine, ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("num_spatial_dims", [1, 4])
def test_other_ranks_raise(num_spatial_dims):
    factors = [[2] * num_spatial_dims]
    with pytest.raises(ValueError, match="2 or 3 spatial dims"):
        UNet(1, num_spatial_dims, 8, 2, 16, factors, num_spatial_dims)


# -- transposed-conv upsampling (constant_upsample=False) ----------------------


def _tconv_pair(ndim, factors):
    return unet_pair(ndim, factors, constant_upsample=False)


TCONV_CASES = [(2, ((2, 2),), (60, 60)), (2, ((2, 2), (3, 3)), (88, 88)),
               (3, ((1, 2, 2),), (20, 36, 36)), (3, ((2, 2, 2),), (28, 28, 28))]


@pytest.mark.parametrize("ndim,factors,size", TCONV_CASES)
def test_tconv_forward_matches_jax(ndim, factors, size):
    """float32, atol 2e-4 and rtol 1e-4 as the nearest-upsampling forward."""
    spec, params, model = _tconv_pair(ndim, factors)
    x = np.random.default_rng(0).normal(size=(2, *size, 1)).astype(np.float32)
    with torch.no_grad():
        mine = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(forward(spec, params, jnp.asarray(x)))
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("ndim,factors,size", [TCONV_CASES[0], TCONV_CASES[2]])
def test_tconv_gradients_match_jax_grad(ndim, factors, size):
    """Every parameter's gradient, the transposed convs' included, within
    rtol 1e-4 and 1e-4 x max|g| of ``jax.grad``'s (float32)."""
    spec, params, model = _tconv_pair(ndim, factors)
    x = np.random.default_rng(2).random((2, *size, 1)).astype(np.float32)
    out_shape = np.asarray(forward(spec, params, jnp.asarray(x))).shape
    w = np.random.default_rng(3).standard_normal(out_shape).astype(np.float32)
    grads = jax.grad(lambda p: (forward(spec, p, jnp.asarray(x)) * w).sum())(params)
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    (model(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    assert any(name.startswith("backbone.r_up.") for name, _ in model.named_parameters())
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=name)


def test_tconv_upsample_is_torch_conv_transpose():
    """The block matmul + interleave is ``ConvTranspose`` with kernel =
    stride, on the module's own weights (float32, atol 1e-5)."""
    _, _, model = _tconv_pair(3, ((1, 2, 2),))
    up = model.backbone.r_up[0][0]
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 5, 6, 7, 16)).astype(np.float32))
    with torch.no_grad():
        mine = up(x, torch.float32)
        ref = up.up(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert mine.shape == (2, 5, 12, 14, 16)
    np.testing.assert_allclose(mine.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("ndim,factors", [(2, ((2, 2), (2, 2))), (3, ((1, 2, 2),))])
def test_tconv_pth_from_jax_export_loads_strictly(tmp_path, ndim, factors):
    """``state_dict_from_jax_params`` carries the transposed convs to
    funlib's ``backbone.r_up.0.<l>.up`` bit for bit, and so does
    ``save_torch_checkpoint``; the port loads its ``.pth`` strictly."""
    _, params, model = _tconv_pair(ndim, factors)
    bridged = state_dict_from_jax_params(params)
    assert bridged.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(bridged[k], v, rtol=0, atol=0)
    path = tmp_path / "tconv.pth"
    save_torch_checkpoint(path, params, iteration=3)
    assert any(k.startswith("backbone.r_up.0.") for k in torch.load(path)["model_state_dict"])
    loaded = UNet(1, ndim, 8, 2, 16, [list(f) for f in factors], ndim, constant_upsample=False)
    assert load_checkpoint(path, loaded)["iteration"] == 3
    for (k, a), (k2, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_upsample_mode_mismatch_raises(tmp_path):
    """The JAX package's two refusals: transposed-conv weights are never
    ignored, and never missing where the model needs them."""
    _, params, _ = _tconv_pair(2, ((2, 2),))
    tconv = tmp_path / "tconv.pth"
    save_torch_checkpoint(tconv, params)
    with pytest.raises(ValueError, match="set constant_upsample = false"):
        load_checkpoint(tconv, UNet(1, 2, 8, 2, 16, [[2, 2]], 2))
    _, nearest_params, _ = _pair()
    nearest = tmp_path / "nearest.pth"
    save_torch_checkpoint(nearest, nearest_params)
    with pytest.raises(ValueError, match="set constant_upsample = true"):
        load_checkpoint(nearest, UNet(1, 2, 8, 2, 16, [[2, 2]], 2, constant_upsample=False))
