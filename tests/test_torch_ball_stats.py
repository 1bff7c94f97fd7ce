"""The port's ball statistics (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellulus_tpu.ops.pallas_mean_shift import ball_stats_pallas
from cellulus_tpu_torch.ops.ball_stats import ball_stats, point_set


def _port(centers, x, valid, bw2):
    points = point_set(torch.from_numpy(x), torch.from_numpy(valid))
    counts, sums = ball_stats(torch.from_numpy(centers), points, bw2)
    return counts.numpy(), sums.numpy()


@pytest.mark.parametrize("S,N,d", [(37, 1000, 2), (5, 130, 3), (128, 512, 2)])
def test_ball_stats_matches_pallas(S, N, d):
    rng = np.random.default_rng(S * 1000 + N)
    centers = (rng.normal(size=(S, d)) * 3).astype(np.float32)
    x = (rng.normal(size=(N, d)) * 3).astype(np.float32)
    valid = rng.random(N) > 0.1
    bw2 = 1.5 * 1.5
    counts, sums = _port(centers, x, valid, bw2)
    ref_counts, ref_sums = ball_stats_pallas(
        jnp.asarray(centers), jnp.asarray(x), jnp.asarray(valid), bw2, interpret=True
    )
    np.testing.assert_allclose(counts, np.asarray(ref_counts), rtol=1e-6)
    np.testing.assert_allclose(sums, np.asarray(ref_sums), rtol=1e-5, atol=1e-5)


def test_ball_stats_boundary_inclusive():
    centers = np.array([[0.0, 0.0]], np.float32)
    x = np.array([[1.0, 0.0], [1.0001, 0.0]], np.float32)
    counts, sums = _port(centers, x, np.ones(2, bool), 1.0)
    ref_counts, _ = ball_stats_pallas(
        jnp.asarray(centers), jnp.asarray(x), jnp.asarray(np.ones(2, bool)), 1.0,
        interpret=True,
    )
    # dist <= bandwidth is inclusive (sklearn radius query semantics)
    assert counts[0] == 1.0 == float(ref_counts[0])
    np.testing.assert_array_equal(sums[0], [1.0, 0.0])


def test_ball_stats_rejects_other_devices():
    """A tensor that is not on the CPU never takes the plain version."""
    points = point_set(torch.zeros((4, 2)), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        ball_stats(torch.zeros((2, 2), device="meta"), points, 1.0)
