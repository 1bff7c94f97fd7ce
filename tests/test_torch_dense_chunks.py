"""Dense loss in chunks: the dense step reads nothing on the host (its R
reference slices are one gather indexed on the device), so
``steps_per_dispatch = K > 1`` runs it like the other key-driven modes, on
the card as one CUDA graph a chunk. Here (CPU) K = 2 against K = 1 steps in
2D and 3D, bit-equal; the step against the JAX package's is
``tests/test_torch_grid_loss.py``."""

import os

import numpy as np
import pytest
import torch

import cellulus_tpu_torch
from cellulus_tpu_torch.configs import ExperimentConfig
from cellulus_tpu_torch.datasets import PairSampler
from cellulus_tpu_torch.train import make_train_step_dense
from tests.unet_pairs import unet_pair

MODEL = {"num_fmaps": 8, "fmap_inc_factor": 2, "features_in_last_layer": 16}


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Totals:
    """An optimizer that only hands back a step's loss terms."""

    def zero_grad(self):
        pass

    def step(self, *totals):
        return totals


def _no_host_reads(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the dense step read a tensor on the host")

    for name in ("tolist", "item", "numpy", "__int__", "__float__", "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("ndim,factors,crop", [(2, [[2, 2]], (60, 76)),
                                               (3, [[1, 2, 2]], (20, 36, 44))])
def test_dense_step_reads_nothing_on_the_host(monkeypatch, ndim, factors, crop):
    """The whole step (draws, forward, the R slices, the loss, backward)
    with every host read of a tensor refused: what a CUDA graph needs."""
    _, _, model = unet_pair(ndim, factors)
    out = tuple(model_out for model_out in _output(model, crop))
    sampler = PairSampler(out, density=0.1, kappa=3.0, count_mode="all_dims")
    step = make_train_step_dense(model.train(), _Totals(), 10.0, 1e-2, sampler, 2)
    raw = torch.from_numpy(np.random.default_rng(0).random((2, *crop, 1)).astype(np.float32))
    generator = torch.Generator().manual_seed(0)
    _no_host_reads(monkeypatch)
    loss, oce, field = step(raw, generator)
    monkeypatch.undo()
    assert np.isfinite(float(loss)) and float(oce) > 0 and field.shape == (2, *out, ndim)


def _output(model, crop):
    from cellulus_tpu_torch.models import compute_geometry

    return compute_geometry(crop, model.downsampling_factors).output_size


def _train(container, workdir, **train):
    os.makedirs(workdir)
    config = ExperimentConfig(**{"object_size": 10, "model_config": train.pop("model"),
                                 "train_config": train})
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        return cellulus_tpu_torch.train(config)
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("ndim", [2, 3])
def test_dense_chunks_equal_single_steps(blob_container_2d, blob_container_3d, tmp_path, ndim):
    """K = 2 (with a tail chunk of 1) and K = 1 from one seed: per-iteration
    losses bit-equal and the same final weights."""
    if ndim == 2:
        container, model = blob_container_2d, MODEL
        shape = dict(crop_size=[60, 60], kappa=5.0)
    else:
        container, model = blob_container_3d, {**MODEL, "downsampling_factors": [[1, 2, 2]]}
        shape = dict(crop_size=[20, 36, 36], kappa=3.0, pair_count_mode="all_dims")
    states = {}
    for k in (1, 2):
        with pytest.warns(UserWarning, match="EXPERIMENTAL"):
            states[k] = _train(
                container, tmp_path / f"k{k}", model=model, device="cpu", batch_size=2,
                max_iterations=5, num_workers=1, elastic_deform=False, loss_mode="dense",
                steps_per_dispatch=k, save_model_every=1000, save_best_model_every=2,
                save_snapshot_every=1000, **shape,
                train_data_config={"container_path": str(container), "dataset_name": "train"})
    assert len(states[2]["logger_data"]["loss"]) == 5
    for key in ("loss", "oce_loss"):
        assert states[2]["logger_data"][key] == states[1]["logger_data"][key]
    for name, value in states[1]["model_state_dict"].items():
        assert torch.equal(states[2]["model_state_dict"][name], value), name
