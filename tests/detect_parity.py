"""The JAX package's and the port's kept centres of one mean-shift fit, for
comparing their detections up to rounding
(``cellulus_tpu_torch.utils.parity``)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from cellulus_tpu.ops import mean_shift as jax_ms
from cellulus_tpu_torch.ops import mean_shift as ms


def kept_centres_port(X_fit, seeds, bandwidth, max_iter=300):
    """The port's kept centres (CPU) of a fit, in label order."""
    centers, n_final, _ = ms.launch_fit(torch.from_numpy(np.ascontiguousarray(X_fit)), seeds,
                                        bandwidth, max_iter)
    return ms._dedupe(centers, n_final, ms.fit_thresholds(bandwidth)[0]).numpy()


def kept_centres_jax(X_fit, seeds, bandwidth, max_iter=300):
    """The JAX package's kept centres of the same fit, in label order."""
    n_pad = jax_ms._next_pow2(max(len(X_fit), 256))
    s_pad = jax_ms._next_pow2(max(len(seeds), 64))
    chunk = max(256, min(1 << 18, (1 << 26) // s_pad, n_pad))
    while n_pad % chunk:
        chunk //= 2
    sc, unique = jax_ms._fit_kernel(
        jnp.asarray(jax_ms._pad_rows(X_fit, n_pad)),
        jnp.asarray(jax_ms._pad_rows(np.ones(len(X_fit), bool), n_pad)),
        jnp.asarray(jax_ms._pad_rows(np.asarray(seeds, np.float32), s_pad)),
        jnp.asarray(jax_ms._pad_rows(np.ones(len(seeds), bool), s_pad)),
        jnp.float32(bandwidth), max_iter=max_iter, chunk=chunk)
    return np.asarray(sc)[np.asarray(unique)]
