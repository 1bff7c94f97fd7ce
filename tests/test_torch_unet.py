"""The port's U-Net and TTA (CPU) against the JAX package's, on the same
weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellulus_tpu.models import UNetSpec, forward, init_params, tta_embeddings as jax_tta
from cellulus_tpu.models.torch_export import save_torch_checkpoint
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
    with pytest.raises(ValueError, match="torch_export"):
        load_checkpoint(tmp_path / "best_loss.ckpt", UNet(1, 2, 8, 2, 16, [[2, 2]], 2))


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


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        UNet(1, 2, 8, 2, 16, [[2, 2]], 2, constant_upsample=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        UNet(1, 3, 8, 2, 16, [[1, 2, 2]], 3)
