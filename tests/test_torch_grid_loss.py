"""The grid and dense loss steps of the port against the JAX package's
``make_train_step_grid`` / ``make_train_step_dense`` (CPU), on the same
weights, crops and draws, and ``remat``'s gradients.

The draws are made with the JAX step's own key splits
(``cellulus_tpu/train.py:370-386`` for grid, ``:276-283`` for dense) and
passed to the port's step as ``draws``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellulus_tpu.datasets.sampling import PairSampler as JaxPairSampler
from cellulus_tpu.models import compute_geometry as jax_compute_geometry
from cellulus_tpu.train import make_optimizer as jax_make_optimizer
from cellulus_tpu.train import make_train_step_dense as jax_make_train_step_dense
from cellulus_tpu.train import make_train_step_grid as jax_make_train_step_grid
from cellulus_tpu_torch.datasets import PairSampler
from cellulus_tpu_torch.models import state_dict_from_jax_params
from cellulus_tpu_torch.train import (
    grid_anchor_offsets,
    grid_anchors,
    grid_layout,
    make_optimizer,
    make_train_step_dense,
    make_train_step_grid,
)
from tests.unet_pairs import unet_pair

LR, TEMPERATURE, REG = 1e-3, 10.0, 1e-2
BATCH = 2
# non-square crops, so a transposed axis cannot hide
CASES = {
    2: dict(factors=[[2, 2]], crop=(60, 76), kappa=5.0, density=0.1),
    3: dict(factors=[[1, 2, 2]], crop=(20, 36, 44), kappa=3.0, density=0.1),
}


def _setup(ndim):
    case = CASES[ndim]
    spec, params, model = unet_pair(ndim, case["factors"])
    out = tuple(jax_compute_geometry(case["crop"], spec.downsampling_factors).output_size)
    kw = dict(density=case["density"], kappa=case["kappa"], count_mode="all_dims")
    return spec, params, model, out, JaxPairSampler(out, **kw), PairSampler(out, **kw)


def _jax_draws(kind, key, sampler, out):
    """The draws of the JAX step, from its own key splits."""
    ndim = len(out)
    table = np.asarray(sampler._offsets)
    if kind == "grid":
        stride, grid_dims, A, _ = grid_layout(sampler)
        k_j, k_off = jax.random.split(key)
        jitter = jax.random.randint(k_j, (ndim,), 0, stride)
        idx = jax.random.randint(k_off, (BATCH, A, sampler.n_references), 0, table.shape[0])
        return torch.from_numpy(np.asarray(jitter).astype(np.int64)), torch.from_numpy(
            np.asarray(idx).astype(np.int64))
    k = int(sampler.kappa)
    unbiased = tuple(s - 2 * k for s in out)
    rate = min(1.0, sampler.n_anchors / float(np.prod(unbiased)))
    k_off, k_mask = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k_off, (sampler.n_references,), 0, table.shape[0]))
    mask = np.asarray(jax.random.bernoulli(k_mask, rate, (BATCH, *unbiased))).astype(np.float32)
    return torch.from_numpy(table[idx].astype(np.int64)), torch.from_numpy(mask)


def _run_both(kind, ndim, precision, steps=3):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[precision]
    spec, params, model, out, jsampler, sampler = _setup(ndim)
    crop = CASES[ndim]["crop"]
    rng = np.random.default_rng(ndim)
    raws = [rng.random((BATCH, *crop, 1)).astype(np.float32) for _ in range(steps)]
    keys = [jax.random.PRNGKey(10 + i) for i in range(steps)]

    jax_make = {"grid": jax_make_train_step_grid, "dense": jax_make_train_step_dense}[kind]
    opt = jax_make_optimizer(LR)
    jstep = jax.jit(jax_make(spec, opt, TEMPERATURE, REG, jsampler, BATCH, jdt))
    state = opt.init(params)
    want = []
    for raw, key in zip(raws, keys):
        params, state, loss, oce, _ = jstep(params, state, jnp.asarray(raw), key)
        want.append((float(loss), float(oce),
                     state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params))))

    make = {"grid": make_train_step_grid, "dense": make_train_step_dense}[kind]
    step = make(model, make_optimizer(model.parameters(), LR), TEMPERATURE, REG, sampler,
                BATCH, tdt, "cpu")
    got = []
    for raw, key in zip(raws, keys):
        loss, oce, _ = step(torch.from_numpy(raw), None,
                            draws=_jax_draws(kind, key, jsampler, out))
        got.append((float(loss), float(oce),
                    {n: p.detach().clone() for n, p in model.named_parameters()}))
    return got, want


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("kind", ["grid", "dense"])
def test_step_matches_jax_float32(kind, ndim):
    """Losses and OCE terms at rtol 1e-5 (sums over thousands of pairs in
    other orders); every parameter after the first and the third step
    within 0.05 x lr (Adam moves a parameter by about lr a step)."""
    got, want = _run_both(kind, ndim, "float32")
    for i in range(3):
        np.testing.assert_allclose(got[i][:2], want[i][:2], rtol=1e-5, err_msg=f"step {i}")
    for i in (0, 2):
        for name, p in got[i][2].items():
            np.testing.assert_allclose(p.numpy(), want[i][2][name].numpy(), atol=0.05 * LR,
                                       err_msg=f"{name} after step {i + 1}")


@pytest.mark.parametrize("kind", ["grid", "dense"])
def test_step_matches_jax_bfloat16(kind):
    """bfloat16, 2D: losses at rtol 1e-2. Parameters after 1 and 3 steps lie
    no farther from the JAX package's bf16 parameters than those lie from
    its own float32 run (the median and the 99th percentile of the
    per-entry distance, plus the float32 bar of 0.05 x lr for the first
    step, where every entry moves by about lr), and all within 6 x lr: bf16 rounding can flip the
    sign of Adam's step where a gradient is small, about 2 x lr a step
    (measured, grid after 3 steps: port vs JAX bf16 99% within 1.11 x lr,
    JAX bf16 vs f32 3.15 x lr)."""
    got, want = _run_both(kind, 2, "bfloat16")
    _, want32 = _run_both(kind, 2, "float32")
    for i in range(3):
        np.testing.assert_allclose(got[i][:2], want[i][:2], rtol=1e-2, err_msg=f"step {i}")
    for i in (0, 2):
        def distances(a, b):
            return np.concatenate([np.abs(a[n].numpy() - b[n].numpy()).ravel() for n in a])

        diffs = distances(got[i][2], want[i][2])
        floor = distances(want[i][2], want32[i][2])
        assert diffs.max() <= 6 * LR, f"step {i + 1}: max {diffs.max() / LR:.2f} x lr"
        for q in (0.5, 0.99):
            assert np.quantile(diffs, q) <= np.quantile(floor, q) + 0.05 * LR, (
                f"step {i + 1}: quantile {q} {np.quantile(diffs, q) / LR:.3f} x lr, JAX bf16 "
                f"vs f32 {np.quantile(floor, q) / LR:.3f} x lr")


@pytest.mark.parametrize("out,kappa,density,mode,want", [
    # the 2D gate (tests/test_quality_gate.py): output 60^2, 500 anchors
    ((60, 60), 5.0, 0.2, "reference", (2, (25, 25), 625, 15, 0.8)),
    # examples/2d: output 212^2, 3,686 anchors
    ((212, 212), 10.0, 0.1, "reference", (3, (64, 64), 4096, 31, 3686 / 4096)),
    # 3D through the same code
    ((24, 60, 60), 6.0, 0.05, "all_dims", (3, (4, 16, 16), 1024, 45, 1382 / 1024)),
])
def test_grid_layout_matches_jax(out, kappa, density, mode, want):
    """stride (Python's round, half to even), grid_dims, A, R and the scale
    n_anchors / A, against the JAX step's own formulas
    (``cellulus_tpu/train.py:362-368``)."""
    jax_sampler = JaxPairSampler(out, density=density, kappa=kappa, count_mode=mode)
    k = int(kappa)
    unbiased = tuple(s - 2 * k for s in out)
    area = float(np.prod(unbiased))
    stride = max(1, int(round((area / max(jax_sampler.n_anchors, 1)) ** (1 / len(out)))))
    grid_dims = tuple(max(1, u // stride) for u in unbiased)
    A = int(np.prod(grid_dims))
    sampler = PairSampler(out, density=density, kappa=kappa, count_mode=mode)
    stride_p, grid_dims_p, A_p, scale_p = grid_layout(sampler)
    assert (stride_p, grid_dims_p, A_p) == (stride, grid_dims, A)
    assert scale_p == jax_sampler.n_anchors / A
    assert (stride_p, grid_dims_p, A_p, sampler.n_references) == want[:4]
    assert scale_p == pytest.approx(want[4], rel=1e-12)


def test_grid_anchors_are_x_first_and_jitter_per_axis():
    """A field whose channels hold each pixel's own (x, y) on a non-square
    output, with a different jitter per axis: the strided read must return
    exactly the anchors' coordinates, x first, and the anchors must step
    along y by the jitter of y and along x by the jitter of x."""
    H, W, k, stride = 30, 44, 5, 3
    grid_dims = ((H - 2 * k) // stride, (W - 2 * k) // stride)
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    field = torch.stack([xs, ys], dim=-1).float()[None].expand(2, H, W, 2)
    jitter = torch.tensor([2, 0])  # y, x
    anchors = grid_anchors(jitter, k, stride, grid_dims)
    got = grid_anchor_offsets(field, jitter, k, stride, grid_dims)
    torch.testing.assert_close(got, anchors.float()[None].expand(2, -1, -1), rtol=0, atol=0)
    x, y = anchors[:, 0].reshape(grid_dims), anchors[:, 1].reshape(grid_dims)
    assert x[0].tolist() == [k + 0 + stride * i for i in range(grid_dims[1])]
    assert y[:, 0].tolist() == [k + 2 + stride * i for i in range(grid_dims[0])]


@pytest.mark.parametrize("ndim", [2, 3])
def test_remat_gradients_equal(ndim):
    """Every gradient with ``remat`` equals the one without (the recompute
    runs the same ops on the same inputs)."""
    _, _, model, _, _, _ = _setup(ndim)
    x = torch.from_numpy(np.random.default_rng(5).random(
        (2, *CASES[ndim]["crop"], 1)).astype(np.float32))
    grads = {}
    for remat in (False, True):
        model.zero_grad()
        model.remat = remat
        model(x).square().sum().backward()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()}
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, rtol=0, atol=0, msg=name)
