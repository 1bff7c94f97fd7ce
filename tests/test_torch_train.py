"""The training slice: OCE loss, coordinate gather, the U-Net's training
path, the train step, the optimizer and the ``train()`` runtime, against
the JAX package on the same weights, crops and pairs (CPU)."""

import csv
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cellulus_tpu
import cellulus_tpu_torch
from cellulus_tpu.configs import ExperimentConfig as JaxExperimentConfig
from cellulus_tpu.criterions import oce_loss as jax_oce_loss
from cellulus_tpu.datasets.sampling import PairSampler as JaxPairSampler
from cellulus_tpu.models import (
    UNetSpec,
    forward,
    init_params,
    select_and_add_coordinates as jax_select,
)
from cellulus_tpu.models.torch_export import save_torch_checkpoint
from cellulus_tpu.train import make_optimizer as jax_make_optimizer
from cellulus_tpu.train import make_train_step as jax_make_train_step
from cellulus_tpu_torch.configs import ExperimentConfig
from cellulus_tpu_torch.criterions import oce_loss
from cellulus_tpu_torch.models import (
    UNet,
    init_unet_,
    select_and_add_coordinates,
    state_dict_from_jax_params,
)
from cellulus_tpu_torch.ops.conv_pass import conv_pass_2d
from cellulus_tpu_torch.train import make_optimizer, make_train_step, make_train_step_fused

SPEC = UNetSpec(1, 2, 8, 2, 16, ((2, 2),), 2)
CROP, OUT = 60, 44  # crop 60 with one [2, 2] level gives a 44^2 output


def _models(seed=0):
    params = init_params(jax.random.PRNGKey(seed), SPEC)
    model = UNet(1, 2, 8, 2, 16, [[2, 2]], 2)
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return params, model


def _batch(B=2, seed=0):
    """Seeded crops and host-sampled pairs (repeated-anchor layout)."""
    rng = np.random.default_rng(seed)
    raw = rng.random((B, CROP, CROP, 1)).astype(np.float32)
    sampler = JaxPairSampler((OUT, OUT), density=0.1, kappa=5.0)
    pairs = [sampler.sample(rng) for _ in range(B)]
    anchors = np.stack([a for a, _ in pairs])
    references = np.stack([r for _, r in pairs])
    return raw, anchors, references


# -- loss and gather ----------------------------------------------------------


def test_oce_loss_and_gather_match_jax_with_the_stop_gradient():
    rng = np.random.default_rng(0)
    offsets = rng.standard_normal((2, 9, 11, 2)).astype(np.float32)
    coords = np.stack([rng.integers(0, 11, (2, 30)), rng.integers(0, 9, (2, 30))], -1)
    refs = np.clip(coords + rng.integers(-2, 3, coords.shape), 0, [10, 8]).astype(np.int32)
    coords = coords.astype(np.int32)

    def jax_loss(o, r_emb_src):
        e_a = jax_select(o, jnp.asarray(coords))
        e_r = jax_select(r_emb_src, jnp.asarray(refs))
        return jax_oce_loss(e_a, e_r, 10.0, 1e-2)[0]

    o = jnp.asarray(offsets)
    want, (g_a, g_r) = jax.value_and_grad(jax_loss, argnums=(0, 1))(o, o)

    ot = torch.from_numpy(offsets).requires_grad_()
    ot_ref = torch.from_numpy(offsets.copy()).requires_grad_()
    e_a = select_and_add_coordinates(ot, torch.from_numpy(coords))
    e_r = select_and_add_coordinates(ot_ref, torch.from_numpy(refs))
    np.testing.assert_array_equal(e_a.detach().numpy(), np.asarray(jax_select(o, jnp.asarray(coords))))
    total, oce, reg = oce_loss(e_a, e_r, 10.0, 1e-2)
    total.backward()
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose((oce + reg).item(), total.item(), rtol=1e-6)
    np.testing.assert_allclose(ot.grad.numpy(), np.asarray(g_a), rtol=1e-5, atol=1e-6)
    # the reference side carries no gradient, in both frameworks
    assert ot_ref.grad is None or not ot_ref.grad.any()
    assert not np.asarray(g_r).any()


# -- U-Net: the K1 repair ---------------------------------------------------------


def test_conv_pass_2d_raises_under_autograd():
    _, model = _models()
    x = torch.rand(1, 20, 20, 1)
    params = model.backbone.l_conv[0].pass_params()
    with pytest.raises(RuntimeError, match="inference-only"):
        conv_pass_2d(x, params)
    with pytest.raises(RuntimeError, match="inference-only"):
        conv_pass_2d(x.requires_grad_(), {k: {n: t.detach() for n, t in v.items()}
                                          for k, v in params.items()})
    with torch.no_grad():
        assert conv_pass_2d(x, params).shape == (1, 16, 16, 8)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 0.1)])
def test_unet_inference_and_training_paths_agree(dtype, atol):
    """f32: the same function to float rounding. bf16: K1 adds the bias
    before its one rounding, the training path rounds the conv output and
    then the bias sum (as the JAX package's ``_conv``), so they differ by
    bf16 ulps carried through the network (atol 0.1 on outputs of order 1)."""
    _, model = _models()
    x = torch.from_numpy(np.random.default_rng(1).random((2, CROP, CROP, 1)).astype(np.float32))
    with torch.no_grad():
        fused = model(x, dtype)
    trained = model(x, dtype)
    assert trained.requires_grad and not fused.requires_grad
    np.testing.assert_allclose(trained.detach().numpy(), fused.numpy(), atol=atol)


def test_training_path_gradients_match_jax_grad():
    params, model = _models()
    x = np.random.default_rng(2).random((2, CROP, CROP, 1)).astype(np.float32)
    w = np.random.default_rng(3).standard_normal((2, OUT, OUT, 2)).astype(np.float32)
    grads = jax.grad(lambda p: (forward(SPEC, p, jnp.asarray(x)) * w).sum())(params)
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    (model(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=name)


def test_init_schemes_draw_the_stated_distributions():
    model = UNet(1, 2, 8, 2, 16, [[2, 2]], 2)
    conv = model.backbone.r_conv[0][0].conv_pass[0]  # fan_in 9 * 24
    bound = 1 / np.sqrt(conv.weight[0].numel())
    init_unet_(model, "kaiming_normal", torch.Generator().manual_seed(0))
    np.testing.assert_allclose(conv.weight.std().item(), np.sqrt(2) * bound, rtol=0.1)
    assert conv.bias.abs().max() <= bound
    init_unet_(model, "torch_default", torch.Generator().manual_seed(0))
    assert conv.weight.abs().max() <= bound and conv.weight.abs().max() > 0.9 * bound
    a = init_unet_(UNet(1, 2, 8, 2, 16, [[2, 2]], 2), "torch_default", torch.Generator().manual_seed(0))
    for p, q in zip(a.parameters(), model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


# -- the train step ----------------------------------------------------------------


def _jax_run(params, batches, lr, dtype):
    opt = jax_make_optimizer(lr)
    step = jax.jit(jax_make_train_step(SPEC, opt, 10.0, 1e-5, dtype))
    state = opt.init(params)
    losses = []
    for raw, anc, ref in batches:
        params, state, loss, _, _ = step(params, state, jnp.asarray(raw), jnp.asarray(anc),
                                         jnp.asarray(ref))
        losses.append(float(loss))
    return params, losses


def _jax_grads(params, batch, dtype):
    raw, anc, ref = (jnp.asarray(a) for a in batch)

    def loss_fn(p):
        offsets = forward(SPEC, p, raw, dtype)
        return jax_oce_loss(jax_select(offsets, anc), jax_select(offsets, ref), 10.0, 1e-5)[0]

    return state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(params)))


def _port_run(model, batches, lr, dtype):
    opt = make_optimizer(model.parameters(), lr)
    step = make_train_step(model, opt, 10.0, 1e-5, dtype)
    losses, first_grads = [], None
    for raw, anc, ref in batches:
        loss, _, _ = step(torch.from_numpy(raw), torch.from_numpy(anc), torch.from_numpy(ref))
        losses.append(float(loss))
        if first_grads is None:
            first_grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return losses, first_grads


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_train_step_matches_jax(precision):
    """Three steps of the port's make_train_step against the JAX package's
    on the same weights, crops and pairs, each with a fresh Adam.

    float32: losses at rtol 1e-5; step-1 gradients per tensor within
    1e-4 x max|g|; parameters after 3 steps within 0.05 x lr (Adam moves
    each parameter by about lr a step, so this is 5% of one step).
    bfloat16: losses at rtol 1e-2; gradients within 0.1 x max|g| (both
    frameworks' bf16 gradients lie 10-25% of max|g| from the f32 one and
    agree on the weights, but a bias gradient is a sum over every pixel of
    a bf16 cotangent, which the two accumulate differently: up to 7%
    apart); parameters: the median entry within 0.05 x lr, 99% within
    1 x lr, all within 6 x lr (bf16 rounding can flip the sign of Adam's
    step where a gradient is small, which moves that entry by about 2 x lr
    in each of the 3 steps; measured: median 0.003, 99% 0.51, max 3.3 x lr).
    """
    jdt, tdt = (jnp.float32, torch.float32) if precision == "float32" else (jnp.bfloat16, torch.bfloat16)
    loss_tol, grad_tol, param_tol = (1e-5, 1e-4, 0.05) if precision == "float32" else (1e-2, 0.1, 6.0)
    lr = 1e-3
    params, model = _models()
    batches = [_batch(seed=s) for s in range(3)]
    want_grads = _jax_grads(params, batches[0], jdt)
    params_after, want_losses = _jax_run(params, batches, lr, jdt)
    losses, grads = _port_run(model, batches, lr, tdt)

    np.testing.assert_allclose(losses, want_losses, rtol=loss_tol)
    for name, g in grads.items():
        ref = want_grads[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, atol=grad_tol * np.abs(ref).max(), err_msg=name)
    want_params = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params_after))
    diffs = []
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].numpy(),
                                   atol=param_tol * lr, err_msg=name)
        diffs.append(np.abs(p.detach().numpy() - want_params[name].numpy()).ravel())
    if precision == "bfloat16":
        diffs = np.concatenate(diffs)
        assert np.median(diffs) <= 0.05 * lr and np.quantile(diffs, 0.99) <= lr


def test_grouped_step_equals_repeated_anchor_step():
    """The fused step (each anchor gathered once, broadcast over its R
    references) gives the repeated-anchor step's loss and update."""
    sampler = JaxPairSampler((OUT, OUT), density=0.1, kappa=5.0)
    rng = np.random.default_rng(4)
    A, R = sampler.n_anchors, sampler.n_references
    anchors = np.stack([rng.integers(5, OUT - 4, (A, 2)) for _ in range(2)])
    offsets = sampler._offsets[rng.integers(0, len(sampler._offsets), (2, A, R))]
    references = anchors[:, :, None, :] + offsets
    raw = torch.from_numpy(rng.random((2, CROP, CROP, 1)).astype(np.float32))

    class FixedPairs:
        def device_sampler_grouped(self, device):
            return lambda generator, batch: (torch.from_numpy(anchors), torch.from_numpy(references))

    _, m1 = _models()
    _, m2 = _models()
    step1 = make_train_step(m1, make_optimizer(m1.parameters(), 1e-3), 10.0, 1e-5)
    step2 = make_train_step_fused(m2, make_optimizer(m2.parameters(), 1e-3), 10.0, 1e-5,
                                  FixedPairs(), 2)
    l1, o1, _ = step1(raw, torch.from_numpy(np.repeat(anchors, R, axis=1)),
                      torch.from_numpy(references.reshape(2, A * R, 2)))
    l2, o2, _ = step2(raw, None)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    np.testing.assert_allclose(float(o2), float(o1), rtol=1e-6)
    # the broadcast sums the R copies' gradients in another order: rtol 1e-5
    for p, q in zip(m1.parameters(), m2.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=1e-5, atol=1e-7)


# -- the optimizer -----------------------------------------------------------------


@pytest.mark.parametrize("options", [
    {"lr_milestones": [2, 4], "lr_decay_factor": 0.1},
    {"grad_clip_norm": 1.0},
    {"grad_clip_norm": 1.0, "log_grad_norm": True},
])
def test_optimizer_options_match_make_optimizer(options):
    """Six updates from the same gradients: parameters at rtol 1e-5 after
    each (clip_grad_norm_ divides by norm + 1e-6, optax by norm: 2e-6
    apart after four clipped updates), and the logged raw norm at rtol 1e-6."""
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal((4, 3)).astype(np.float32)
    jopt = jax_make_optimizer(1e-2, **options)
    jparams = {"w": jnp.asarray(p0)}
    jstate = jopt.init(jparams)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([w], 1e-2, **options)
    for i in range(6):
        g = (rng.standard_normal((4, 3)) * (3.0 if i % 2 else 0.1)).astype(np.float32)
        updates, jstate = jopt.update({"w": jnp.asarray(g)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        w.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jparams["w"]), rtol=1e-5,
                                   atol=1e-7, err_msg=f"update {i}")
        if options.get("log_grad_norm"):
            np.testing.assert_allclose(float(opt.grad_norm), float(jstate[0]["grad_norm"]),
                                       rtol=1e-6)


def test_optimizer_resume_keeps_the_milestone_count():
    w = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([w], 1.0, lr_milestones=[2], lr_decay_factor=0.5)
    for _ in range(3):
        w.grad = torch.ones(3)
        opt.step()
    state = opt.state_dict()
    w2 = torch.nn.Parameter(w.detach().clone())
    opt2 = make_optimizer([w2], 1.0, lr_milestones=[2], lr_decay_factor=0.5)
    opt2.load_state_dict(state)
    assert opt2.count == 3 and opt2.learning_rate_at(opt2.count) == 0.5
    assert opt2.adam.param_groups[0]["lr"] == 1.0  # this run's hyper-parameters


# -- the runtime ---------------------------------------------------------------------


def _train_dict(container, **overrides):
    train = {
        "batch_size": 2,
        "crop_size": [CROP, CROP],
        "kappa": 5.0,
        "max_iterations": 3,
        "num_workers": 1,
        "elastic_deform": False,
        "device_pair_sampling": False,
        "save_model_every": 2,
        "save_best_model_every": 2,
        "save_snapshot_every": 2,
        "train_data_config": {"container_path": str(container), "dataset_name": "train"},
    }
    train.update(overrides)
    return {
        "object_size": 10,
        "model_config": {"num_fmaps": 8, "fmap_inc_factor": 2, "features_in_last_layer": 16},
        "train_config": train,
    }


def _port_config(container, checkpoint=None, **overrides):
    config = ExperimentConfig(**_train_dict(container, device="cpu", **overrides))
    config.model_config.checkpoint = checkpoint
    return config


def _csv_rows(path):
    with open(path) as f:
        return [[float(v) for v in row[1:3]] for row in list(csv.reader(f))[1:]]


def test_train_runtime_matches_jax(blob_container_2d, tmp_path, monkeypatch):
    """JAX's train() and the port's on one tiny config (elastic off, host
    pairs, one worker, so both draw the same numpy stream), both starting
    from one .pth: their loss.csv rows agree at rtol 1e-5."""
    start = tmp_path / "start.pth"
    save_torch_checkpoint(start, init_params(jax.random.PRNGKey(0), SPEC), iteration=-1,
                          logger_data={"loss": [], "oce_loss": []})
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_config = JaxExperimentConfig(**_train_dict(blob_container_2d))
    jax_config.model_config.checkpoint = str(start)
    cellulus_tpu.train(jax_config)
    monkeypatch.chdir(tmp_path / "port")
    state = cellulus_tpu_torch.train(_port_config(blob_container_2d, str(start)))

    want, got = _csv_rows(tmp_path / "jax" / "loss.csv"), _csv_rows(tmp_path / "port" / "loss.csv")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert state["iteration"] == 2
    names = sorted(os.listdir("models"))
    assert names == ["000000.pth", "000002.pth", "best_loss.pth"]
    saved = torch.load(Path("models") / "000002.pth", weights_only=True)
    assert set(saved) == {"iteration", "lowest_loss", "model_state_dict", "optim_state_dict",
                          "logger_data"}
    assert saved["iteration"] == 2 and saved["optim_state_dict"]["state"]
    assert Path("snapshots.zarr/2/prediction").exists()


@pytest.fixture(scope="module")
def one_crop_container(tmp_path_factory):
    """One sample exactly one crop in size: every crop is the same image, so
    a resumed run sees the data of an uninterrupted one."""
    from tests.synthetic import make_blob_container

    path = tmp_path_factory.mktemp("one_crop") / "data.zarr"
    make_blob_container(path, num_samples=1, size=CROP, ndim=2, seed=4)
    return path


@pytest.mark.parametrize("device_pairs", [True, False])
def test_resume_reproduces_an_uninterrupted_run(one_crop_container, tmp_path, monkeypatch,
                                                 device_pairs):
    """A resume starts at iteration + 1 with the Adam moments and the loss
    history of the checkpoint. With device pairs (drawn from (seed + 17,
    iteration)) its losses and weights equal the uninterrupted run's; host
    pairs restart their stream (as in the JAX package), so there only the
    carried history is compared."""
    kw = dict(device_pair_sampling=device_pairs, save_model_every=1, save_best_model_every=1,
              save_snapshot_every=100)
    monkeypatch.chdir(tmp_path)
    full = cellulus_tpu_torch.train(_port_config(one_crop_container, max_iterations=4, **kw))
    os.rename("models", "models_full")
    part = cellulus_tpu_torch.train(_port_config(one_crop_container, max_iterations=2, **kw))
    resumed = cellulus_tpu_torch.train(
        _port_config(one_crop_container, "models/000001.pth", max_iterations=4, **kw))
    assert part["iteration"] == 1 and resumed["iteration"] == 3
    assert len(resumed["logger_data"]["loss"]) == 4  # the history carries over
    np.testing.assert_allclose(resumed["logger_data"]["loss"][:2], full["logger_data"]["loss"][:2],
                               rtol=1e-6)
    if device_pairs:
        np.testing.assert_allclose(resumed["logger_data"]["loss"], full["logger_data"]["loss"],
                                   rtol=1e-5)
        for k, v in full["model_state_dict"].items():
            np.testing.assert_allclose(resumed["model_state_dict"][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_stop_file_checkpoints_and_exits(one_crop_container, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    Path("STOP").touch()
    os.utime("STOP", (1e9, 1e9))  # a stale sentinel is ignored

    class TouchOnSecondFetch(list):
        def append(self, t):
            super().append(t)
            if len(self) == 2:
                Path("STOP").touch()

    with pytest.warns(UserWarning, match="predates this run"):
        state = cellulus_tpu_torch.train(
            _port_config(one_crop_container, max_iterations=10, save_model_every=100,
                         save_best_model_every=100, save_snapshot_every=100),
            TouchOnSecondFetch())
    # the second fetch (iteration 1's loss) happens during iteration 2
    assert state["iteration"] == 2
    assert sorted(os.listdir("models")) == ["000000.pth", "000002.pth", "best_loss.pth"]
    assert torch.load("models/000002.pth", weights_only=True)["iteration"] == 2


@pytest.mark.parametrize("option", [{"data_parallelism": 2}])
def test_unported_options_raise(one_crop_container, tmp_path, monkeypatch, option):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cellulus_tpu_torch.train(_port_config(one_crop_container, **option))


@pytest.mark.parametrize("option", [
    {"transfer_precision": "native"}, {"remat": True}, {"packed_dw": True},
])
def test_host_pair_options_match_jax(blob_container_2d, tmp_path, monkeypatch, option):
    """Options that keep the host pair stream: the JAX package's train() and
    the port's with the option, from one .pth, give loss.csv rows that
    agree at rtol 1e-5 (as without it, ``test_train_runtime_matches_jax``)."""
    start = tmp_path / "start.pth"
    save_torch_checkpoint(start, init_params(jax.random.PRNGKey(0), SPEC), iteration=-1,
                          logger_data={"loss": [], "oce_loss": []})
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_config = JaxExperimentConfig(**_train_dict(blob_container_2d, **option))
    jax_config.model_config.checkpoint = str(start)
    cellulus_tpu.train(jax_config)
    monkeypatch.chdir(tmp_path / "port")
    state = cellulus_tpu_torch.train(_port_config(blob_container_2d, str(start), **option))
    want, got = _csv_rows(tmp_path / "jax" / "loss.csv"), _csv_rows(tmp_path / "port" / "loss.csv")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert state["iteration"] == 2


@pytest.mark.parametrize("option", [
    {"loss_mode": "grid"},
    {"loss_mode": "dense"},
    {"elastic_deform": True, "elastic_on_device": True},
])
def test_key_driven_options_run_beside_pairs(one_crop_container, tmp_path, monkeypatch,
                                             option):
    """Options whose draws come from the step's generator (the JAX package
    draws from its key, so its loss.csv is another sample): train() runs
    them for 3 steps, and each loss lies within 10% of the device-pair run
    from the same weights on the same crop (grid and dense scale their sums
    to the pair loss's pair count; the warp keeps the crop's statistics).
    Dense's R offsets are shared by the whole step, so its estimate of a
    step's loss is noisy: its first loss within 10%, the others within 50%."""
    common = dict(max_iterations=3, device_pair_sampling=True)
    monkeypatch.chdir(tmp_path)
    pairs = cellulus_tpu_torch.train(_port_config(one_crop_container, **common))
    os.rename("loss.csv", "pairs.csv")
    if option.get("loss_mode") == "dense":
        with pytest.warns(UserWarning, match="dense"):
            state = cellulus_tpu_torch.train(_port_config(one_crop_container, **common,
                                                          **option))
    else:
        state = cellulus_tpu_torch.train(_port_config(one_crop_container, **common, **option))
    got, want = _csv_rows("loss.csv"), _csv_rows("pairs.csv")
    assert len(got) == 3 and np.isfinite(got).all()
    got, want = np.asarray(got)[:, 0], np.asarray(want)[:, 0]
    np.testing.assert_allclose(got[0], want[0], rtol=0.1)
    np.testing.assert_allclose(got, want, rtol=0.5 if option.get("loss_mode") == "dense" else 0.1)
    assert state["iteration"] == 2 and pairs["iteration"] == 2
    assert sorted(os.listdir("models")) == ["000000.pth", "000002.pth", "best_loss.pth"]


def test_pallas_dw_is_accepted(one_crop_container, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    state = cellulus_tpu_torch.train(
        _port_config(one_crop_container, max_iterations=1, pallas_dw=True))
    assert state["iteration"] == 0
