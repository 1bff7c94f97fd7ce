"""Predict options of the JAX package's InferenceConfig that the port
honours or refuses: ``transfer_precision`` and ``spatial_shards``."""

import numpy as np
import pytest

from cellulus_tpu.configs import InferenceConfig as JaxInferenceConfig
from cellulus_tpu.predict import predict_sample as jax_predict_sample
from cellulus_tpu_torch.configs import InferenceConfig
from cellulus_tpu_torch.predict import predict_sample
from tests.unet_pairs import unet_pair

# no noise: both packages' copies are the same, so their RNGs do not matter
_SETTINGS = dict(crop_size=[44, 44], num_infer_iterations=1, p_salt_pepper=0.0,
                 tile_batch_size=2)


def _raw():
    return np.random.default_rng(5).random((1, 61, 57)).astype(np.float32)


def test_transfer_precision_float16_matches_jax():
    """float16 transfer rounds the TTA output to float16 before the copy to
    the host, as the JAX package does: the port's result is its float32
    result rounded to float16, and within one float16 step (2**-10
    relative) plus the packages' float32 gap (2e-4) of the JAX package's."""
    spec, params, model = unet_pair(2, [[2, 2]])
    out = {}
    for precision in ("float32", "float16"):
        ic = InferenceConfig(**_SETTINGS, transfer_precision=precision, device="cpu")
        mine = predict_sample(model, _raw(), ic, 1.0, 0, "cpu")
        ref = jax_predict_sample(
            spec, params, _raw(), JaxInferenceConfig(**_SETTINGS, transfer_precision=precision),
            1.0)
        assert mine.dtype == np.float32 and mine.shape == ref.shape == (3, 61, 57)
        out[precision] = mine, np.asarray(ref)
    mine16, ref16 = out["float16"]
    mine32 = out["float32"][0]
    np.testing.assert_array_equal(mine16, mine32.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(ref16, ref16.astype(np.float16).astype(np.float32))
    assert not np.array_equal(mine16, mine32)
    np.testing.assert_allclose(mine16, ref16, rtol=2**-10, atol=2e-4)


def test_spatial_shards_raise():
    """``spatial_shards = 2`` on CUDA with fewer visible GPUs (none here)
    raises the JAX package's ValueError (``cellulus_tpu/predict.py:138-142``)
    before anything runs; on the CPU it runs over two CPU devices."""
    _, _, model = unet_pair(2, [[2, 2]])
    ic = InferenceConfig(**_SETTINGS, spatial_shards=2, device="cpu")
    with pytest.raises(ValueError, match="spatial_shards=2 but only 0 devices are visible"):
        predict_sample(model, _raw(), ic, 1.0, 0, "cuda:0")
    raw = _raw()[:, :60, :56]  # an extent the valid-conv geometry reaches
    assert predict_sample(model, raw, ic, 1.0, 0, "cpu").shape == (3, 60, 56)
