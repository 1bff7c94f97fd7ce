"""The 3D modules of the port (CPU) against the JAX package's, on the same
weights, volumes, crops and pairs: the anisotropic 3D U-Net and its
gradients, its init, max-pool ties, the geometry, 3D halo removal and cell
segment, 3D crops and ``all_dims`` pair counts, the density-envelope
warnings and the fit kernel's emulation at d = 3. The end-to-end 3D runs
are in ``test_torch_3d_runs.py``."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mean_shift_fit_emu as emu
from cellulus_tpu.configs import DatasetConfig as JaxDatasetConfig
from cellulus_tpu.datasets import get_dataset as jax_get_dataset
from cellulus_tpu.datasets.sampling import PairSampler as JaxPairSampler
from cellulus_tpu.models import compute_geometry as jax_compute_geometry
from cellulus_tpu.models import forward
from cellulus_tpu.models.unet import _max_pool as jax_max_pool
from cellulus_tpu.ops.mean_shift import mean_shift_fit_predict as jax_fit_predict
from cellulus_tpu.ops.morphology import remove_halo_device
from cellulus_tpu.segment import cell_segment_sample as jax_cell_segment_sample
from cellulus_tpu.train import check_3d_density_envelope as jax_envelope
from cellulus_tpu_torch.configs import DatasetConfig
from cellulus_tpu_torch.datasets import PairSampler, get_dataset
from cellulus_tpu_torch.models import compute_geometry, init_unet_, state_dict_from_jax_params
from cellulus_tpu_torch.models.unet import _max_pool
from cellulus_tpu_torch.ops import mean_shift as ms
from cellulus_tpu_torch.ops.ball_stats import point_set
from cellulus_tpu_torch.ops.morphology import halo_removal
from cellulus_tpu_torch.segment import cell_segment_sample
from cellulus_tpu_torch.train import check_3d_density_envelope
from tests.unet_pairs import unet_pair

SIZES = {(1, 2, 2): (20, 36, 36), (2, 2, 2): (28, 28, 28)}


def _same_partition(a, b, background=0):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    if not ((a == background) == (b == background)).all():
        return False
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


# -- the U-Net -------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", list(SIZES))
def test_unet_3d_forward_matches_jax(factor, precision):
    """float32: atol 2e-4, rtol 1e-4 (as in 2D). bfloat16: both round each
    conv output and then its bias sum to bf16, but sum in other orders, so
    they differ by bf16 ulps carried through the net: atol 2e-2 x max|ref|
    (measured: 0.3-0.7%)."""
    spec, params, model = unet_pair(3, [factor])
    x = np.random.default_rng(0).normal(size=(2, *SIZES[factor], 1)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if precision == "float32" else (jnp.bfloat16,
                                                                           torch.bfloat16)
    with torch.no_grad():
        mine = model(torch.from_numpy(x), tdt).numpy()
    ref = np.asarray(forward(spec, params, jnp.asarray(x), jdt))
    assert mine.shape == ref.shape == (2, *compute_geometry(SIZES[factor], [factor]).output_size, 3)
    if precision == "float32":
        np.testing.assert_allclose(mine, ref, atol=2e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(mine, ref, atol=2e-2 * np.abs(ref).max())


def test_unet_3d_training_gradients_match_jax_grad():
    """Every parameter's gradient within rtol 1e-4 and 1e-4 x max|g| of
    ``jax.grad``'s (float32)."""
    spec, params, model = unet_pair(3, [(1, 2, 2)])
    x = np.random.default_rng(2).random((2, *SIZES[(1, 2, 2)], 1)).astype(np.float32)
    w = np.random.default_rng(3).standard_normal((2, 8, 20, 20, 3)).astype(np.float32)
    grads = jax.grad(lambda p: (forward(spec, p, jnp.asarray(x)) * w).sum())(params)
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    (model(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=name)


def test_init_covers_conv3d_and_transposed_convs():
    """``init_unet_`` draws every Conv3d and ConvTranspose3d; a transposed
    conv's fan-in is the JAX package's ``prod(factor) * c_up``
    (``cellulus_tpu/models/unet.py:162-168``)."""
    _, params, model = unet_pair(3, [(1, 2, 2)], num_fmaps=24, inc=3, constant_upsample=False)
    tconv = model.backbone.r_up[0][0].up
    assert isinstance(tconv, torch.nn.ConvTranspose3d)
    jax_fan_in = np.prod(params["up_tconv"]["level0"]["w"].shape[:-1])  # (*factor, c_up)
    assert tconv.weight[0].numel() == 4 * 72 == jax_fan_in
    for m in (tconv, model.backbone.l_conv[1].conv_pass[6]):
        bound = 1 / np.sqrt(m.weight[0].numel())
        np.testing.assert_allclose(m.weight.std().item(), np.sqrt(2) * bound, rtol=0.05)
        assert m.bias.abs().max() <= bound
    init_unet_(model, "torch_default", torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, torch.nn.modules.conv._ConvNd):
            bound = 1 / np.sqrt(m.weight[0].numel())
            assert 0.9 * bound < m.weight.abs().max() <= bound


@pytest.mark.parametrize("factor", [(1, 2, 2), (2, 2, 2)])
def test_max_pool_3d_floors_and_sends_the_gradient_to_the_first_maximum(factor):
    """Odd extents floor; with ties in every window the gradient of each
    window goes to one entry, the one XLA's picks: bit-equal to jax.grad."""
    x = np.random.default_rng(4).integers(0, 3, size=(2, 5, 7, 9, 3)).astype(np.float32)
    w = np.random.default_rng(5).standard_normal(
        (2, 5 // factor[0], 3, 4, 3)).astype(np.float32)
    ref, ref_grad = jax.value_and_grad(
        lambda v: (jax_max_pool(v, factor) * w).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = _max_pool(xt, factor)
    assert y.shape == w.shape
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jax_max_pool(jnp.asarray(x),
                                                                               factor)))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref_grad))


@pytest.mark.parametrize("crop,factors", [((40, 76, 76), [[1, 2, 2]]),
                                          ((44, 44, 44), [[2, 2, 2]]),
                                          ((36, 100, 100), [[1, 2, 2], [1, 2, 2]])])
def test_geometry_3d_matches_jax(crop, factors):
    mine, ref = compute_geometry(crop, factors), jax_compute_geometry(crop, factors)
    assert mine.output_size == ref.output_size and mine.context == ref.context
    assert mine.skip_sizes == ref.skip_sizes and mine.up_sizes == ref.up_sizes
    if crop == (40, 76, 76):  # the examples/3d crop
        assert (mine.output_size, mine.context) == ((28, 60, 60), (6, 8, 8))


# -- segment ---------------------------------------------------------------------


def _label_volume(seed=0, size=24):
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing="ij"), axis=-1)
    labels = np.zeros((size,) * 3, np.uint16)
    for i in range(10):
        c, r = rng.uniform(0, size, 3), rng.uniform(2, 6)
        labels[((grid - c) ** 2).sum(-1) < r * r] = i + 1
    return labels


@pytest.mark.parametrize("grow,shrink", [(3, 6), (2.5, 4)])
def test_halo_removal_3d_bit_equal(grow, shrink):
    """3D grow/shrink halo removal (the default shrink is an 11^3 ball) equals
    the JAX package's on the same labels, bit for bit."""
    labels = _label_volume()
    mine = halo_removal(torch.from_numpy(labels.astype(np.int32)), grow, shrink).numpy()
    ref = remove_halo_device(labels, grow, shrink)
    assert (mine != labels).any() and (mine > 0).any()
    np.testing.assert_array_equal(mine.astype(np.uint16), ref)


@pytest.mark.parametrize("min_size", [0, 20])
def test_cell_segment_sample_3d_bit_equal(min_size):
    labels = _label_volume(seed=1)
    mine = cell_segment_sample(labels, 2, 3, min_size, "cpu")
    ref = jax_cell_segment_sample(labels, 2, 3, min_size)
    assert mine.dtype == ref.dtype
    np.testing.assert_array_equal(mine, ref)


# -- datasets ----------------------------------------------------------------------


def _dataset_kwargs(elastic, mode):
    return dict(crop_size=(20, 36, 36), elastic_deform=elastic, control_point_spacing=8,
                control_point_jitter=1.0, density=0.1, kappa=3.0, normalization_factor=None,
                output_shape=(8, 20, 20), seed=3, pair_count_mode=mode)


@pytest.mark.parametrize("elastic,mode", [(False, "all_dims"), (True, "all_dims"),
                                          (False, "reference")])
def test_3d_crops_and_pairs_are_bit_equal(blob_container_3d, elastic, mode):
    cfg = {"container_path": str(blob_container_3d), "dataset_name": "train"}
    mine = get_dataset(DatasetConfig(**cfg), **_dataset_kwargs(elastic, mode)).iterate(11)
    ref = jax_get_dataset(JaxDatasetConfig(**cfg), **_dataset_kwargs(elastic, mode)).iterate(11)
    for _ in range(3):
        got, want = next(mine), next(ref)
        assert got[0].shape == (1, 20, 36, 36) and got[1].shape[1] == 3
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("output_shape,kappa,density", [((28, 60, 60), 6.0, 0.05),
                                                        ((8, 20, 20), 3.0, 0.1)])
def test_all_dims_pair_counts_match_jax(output_shape, kappa, density):
    """``all_dims`` counts anchors over the whole unbiased volume and
    references over the kappa-ball's volume; the torch device sampler draws
    them inside the bounds and the ball."""
    for mode in ("all_dims", "reference"):
        mine = PairSampler(output_shape, density, kappa, mode)
        ref = JaxPairSampler(output_shape, density, kappa, mode)
        assert (mine.n_anchors, mine.n_references) == (ref.n_anchors, ref.n_references)
    unbiased = [s - 2 * kappa for s in output_shape]
    assert mine.n_anchors != int(density * np.prod(unbiased))  # "reference" uses two dims
    mine = PairSampler(output_shape, density, kappa, "all_dims")
    assert mine.n_anchors == int(density * np.prod(unbiased))
    assert mine.n_references == int(density * 4 / 3 * np.pi * kappa**3)
    anchors, references = mine.device_sampler_grouped("cpu")(torch.Generator().manual_seed(0), 2)
    assert anchors.shape == (2, mine.n_anchors, 3)
    assert references.shape == (2, mine.n_anchors, mine.n_references, 3)
    offsets = references - anchors[:, :, None, :]
    assert ((offsets**2).sum(-1) < kappa**2).all() and (offsets != 0).any(-1).all()
    highs = torch.tensor([s - int(kappa) for s in reversed(output_shape)])
    assert (anchors >= int(kappa)).all() and (anchors <= highs).all()


# -- train ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndim,density,mode,lr", [
    (3, 0.01, "all_dims", 4e-4), (3, 0.1, "all_dims", 4e-4), (3, 0.05, "reference", 1e-4),
    (3, 0.05, "all_dims", 1e-4), (2, 0.01, "reference", 4e-4)])
def test_density_envelope_warns_as_jax(ndim, density, mode, lr):
    caught = []
    for check in (jax_envelope, check_3d_density_envelope):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            check(ndim, density, mode, lr=lr)
        caught.append([(x.category, str(x.message)) for x in w])
    assert caught[0] == caught[1]
    assert len(caught[1]) == (1 if ndim == 3 and (density, mode) != (0.05, "all_dims") else 0)


# -- the fit kernel's emulation at d = 3 ----------------------------------------------


def test_fit_emulation_at_d3_matches_jax_labels():
    """The one-launch fit's arithmetic (``tests/mean_shift_fit_emu.py``) at
    d = 3 on embeddings of a 3D blob volume, half-way pulled to their blob
    centers (a lattice of background voxels stays): labels equal the JAX
    package's fit as a partition."""
    labels = _label_volume(seed=2, size=16)
    grid = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1).reshape(-1, 3)
    X = grid[:, ::-1].astype(np.float32)  # x-first, as add_coordinate_grid
    flat = labels.ravel()
    for i in np.unique(flat[flat > 0]):
        X[flat == i] = 0.5 * X[flat == i] + 0.5 * X[flat == i].mean(0)
    X = X + np.random.default_rng(0).normal(0, 0.05, X.shape).astype(np.float32)
    bw = np.float32(2.5)
    seeds = ms.bin_seeds(X, bin_size=float(bw))
    points = point_set(torch.from_numpy(X), torch.ones(len(X), dtype=torch.bool))
    centers, n_final, frozen, n_iter = emu.fit(seeds, X, points.x_norm.numpy(),
                                               np.ones(len(X), bool), float(bw * bw),
                                               float(np.float32(1e-3) * bw), 300)
    assert frozen.any() and n_iter.max() > 1
    kept = ms._dedupe(torch.from_numpy(centers), torch.from_numpy(n_final), float(bw * bw))
    mine = ms._predict(torch.from_numpy(X), kept, float(bw * bw)).numpy()
    ref = jax_fit_predict(X, bandwidth=float(bw), seeds=None)
    assert len(np.unique(mine)) > 10
    assert _same_partition(mine, ref, background=-1)
