"""Training resumed from the JAX package's ``.ckpt``: its optax Adam leaves
mapped onto the port's ``torch.optim.Adam`` exactly, with and without
``lr_milestones`` and ``log_grad_norm``, and the port's ``loss.csv`` after
such a resume against the JAX package's own resume (CPU)."""

import csv

import jax
import numpy as np
import pytest
import torch

import cellulus_tpu
import cellulus_tpu_torch
from cellulus_tpu.configs import ExperimentConfig as JaxExperimentConfig
from cellulus_tpu.train import make_optimizer as jax_make_optimizer
from cellulus_tpu.train import pack_state
from cellulus_tpu.utils.checkpoint import save_checkpoint
from cellulus_tpu_torch.configs import ExperimentConfig
from cellulus_tpu_torch.models import adam_moments_from_jax, state_dict_from_jax_params
from cellulus_tpu_torch.train import make_optimizer
from cellulus_tpu_torch.utils.checkpoint import load_train_state
from tests.unet_pairs import unet_pair


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the cases are small, and test workers run side
    by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("log_grad_norm", [False, True])
@pytest.mark.parametrize("lr_milestones", [None, [1, 5]])
def test_adam_state_maps_the_jax_leaves(tmp_path, log_grad_norm, lr_milestones):
    """Two JAX updates on random gradients, written as the JAX package's
    train() writes them, then read by the port: each parameter's
    ``exp_avg`` / ``exp_avg_sq`` is ``scale_by_adam``'s ``mu`` / ``nu``
    under the weights' name map and transpose, bit for bit, and Adam's step
    is the count (the schedule's rate follows it)."""
    spec, params, model = unet_pair(2, ((2, 2),))
    opt = jax_make_optimizer(1e-3, lr_milestones=lr_milestones, log_grad_norm=log_grad_norm)
    opt_state = opt.init(params)
    rng = np.random.default_rng(0)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params)
        _, opt_state = opt.update(grads, opt_state, params)
    path = tmp_path / "000001.ckpt"
    save_checkpoint(path, pack_state(1, 0.5, params, opt_state, {"loss": [2.0, 1.0]}))
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    want_mu = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, adam.mu))
    want_nu = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, adam.nu))

    state = load_train_state(path)
    moments = adam_moments_from_jax(state["jax_params"], state["jax_opt_leaves"], log_grad_norm,
                                    bool(lr_milestones))
    optimizer = make_optimizer(model.parameters(), 1e-3, lr_milestones=lr_milestones,
                               log_grad_norm=log_grad_norm)
    optimizer.load_jax_moments(moments, [n for n, _ in model.named_parameters()])
    assert optimizer.count == 2 == int(adam.count)
    for name, p in model.named_parameters():
        st = optimizer.adam.state[p]
        assert torch.equal(st["exp_avg"], want_mu[name]), name
        assert torch.equal(st["exp_avg_sq"], want_nu[name]), name
    if lr_milestones:
        assert optimizer.learning_rate_at(optimizer.count) == pytest.approx(1e-4)


def _train_dict(container, **overrides):
    train = dict(batch_size=2, crop_size=[60, 60], kappa=5.0, num_workers=1,
                 elastic_deform=False, device_pair_sampling=False, initial_learning_rate=1e-2,
                 lr_milestones=[3], log_grad_norm=True, save_model_every=1,
                 save_best_model_every=1, save_snapshot_every=1000,
                 train_data_config={"container_path": str(container), "dataset_name": "train"})
    train.update(overrides)
    return {"object_size": 10, "train_config": train,
            "model_config": {"num_fmaps": 8, "fmap_inc_factor": 2, "features_in_last_layer": 16}}


def _csv_rows(path):
    with open(path) as f:
        return [[float(v) for v in row[1:4]] for row in list(csv.reader(f))[1:]]


def test_resume_from_a_jax_ckpt_matches_the_jax_resume(blob_container_2d, tmp_path,
                                                        monkeypatch):
    """The JAX package trains 2 steps and writes ``models/000001.ckpt``; it
    and the port each resume from that file to 5 steps (host pairs from one
    numpy stream, lr 1e-2 with a milestone at 3, the grad norm logged):
    their ``loss.csv`` rows agree at rtol 1e-5, as in
    ``tests/test_torch_train.py`` (the grad norm at 1e-4)."""
    monkeypatch.chdir(tmp_path)
    cellulus_tpu.train(JaxExperimentConfig(**_train_dict(blob_container_2d, max_iterations=2)))
    ckpt = str(tmp_path / "models" / "000001.ckpt")
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    config = JaxExperimentConfig(**_train_dict(blob_container_2d, max_iterations=5))
    config.model_config.checkpoint = ckpt
    cellulus_tpu.train(config)
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    config = ExperimentConfig(**_train_dict(blob_container_2d, max_iterations=5, device="cpu"))
    config.model_config.checkpoint = ckpt
    state = cellulus_tpu_torch.train(config)
    assert state["iteration"] == 4
    want, got = _csv_rows(tmp_path / "jax" / "loss.csv"), _csv_rows(tmp_path / "port" / "loss.csv")
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(np.array(got)[:, :2], np.array(want)[:, :2], rtol=1e-5)
    np.testing.assert_allclose(np.array(got)[:, 2], np.array(want)[:, 2], rtol=1e-4)
