"""``steps_per_dispatch = K > 1`` in the port (CPU): the loop in chunks of K
steps against the loop of one step (per-iteration losses bit-equal: on the
CPU the chunk runs its steps eagerly, so only the bookkeeping differs),
against the JAX package's K = 2 loss.csv, and the chunk semantics of
``cellulus_tpu/train.py:1253-1345``: checkpoints at the chunk's end, NaN
``grad_norm`` rows but the last, a tail chunk, a resume across K and a
milestone inside a chunk. The CUDA graph of a chunk is held against eager
steps on the card by ``chip_smoke.py`` ``[spd]``."""

import csv
import os

import jax
import numpy as np
import pytest
import torch

import cellulus_tpu
import cellulus_tpu_torch
from cellulus_tpu.configs import ExperimentConfig as JaxExperimentConfig
from cellulus_tpu.models import UNetSpec, init_params
from cellulus_tpu.models.torch_export import save_torch_checkpoint
from cellulus_tpu_torch.configs import ExperimentConfig
from cellulus_tpu_torch.train import make_optimizer

CROP = 60
MODEL = {"num_fmaps": 8, "fmap_inc_factor": 2, "features_in_last_layer": 16}


@pytest.fixture(autouse=True)
def one_thread():
    """The runs here are tiny: one intra-op thread each keeps them from
    oversubscribing the cores when test workers run side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def one_crop_container(tmp_path_factory):
    """One sample exactly one crop in size (as in test_torch_train.py)."""
    from tests.synthetic import make_blob_container

    path = tmp_path_factory.mktemp("one_crop") / "data.zarr"
    make_blob_container(path, num_samples=1, size=CROP, ndim=2, seed=4)
    return path


def _train_dict(container, **overrides):
    train = {
        "batch_size": 2, "crop_size": [CROP, CROP], "kappa": 5.0, "max_iterations": 6,
        "num_workers": 1, "elastic_deform": False, "device_pair_sampling": False,
        "save_model_every": 1000, "save_best_model_every": 2, "save_snapshot_every": 1000,
        "train_data_config": {"container_path": str(container), "dataset_name": "train"},
    }
    train.update(overrides)
    return {"object_size": 10, "model_config": dict(MODEL), "train_config": train}


def _run(container, workdir, checkpoint=None, **overrides):
    """The port's train() in ``workdir``; returns its final state."""
    os.makedirs(workdir, exist_ok=True)
    config = ExperimentConfig(**_train_dict(container, device="cpu", **overrides))
    config.model_config.checkpoint = checkpoint
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        return cellulus_tpu_torch.train(config)
    finally:
        os.chdir(cwd)


def _csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [[float(v) for v in row[1:]] for row in rows[1:]]


MODES = {
    "host_pairs": {},
    "device_pairs": {"device_pair_sampling": True},
    "grid": {"loss_mode": "grid"},
    "elastic_on_device": {"device_pair_sampling": True, "elastic_deform": True,
                          "elastic_on_device": True},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_chunks_equal_single_steps(one_crop_container, tmp_path, mode):
    """K = 3 and K = 1 from the same seed: per-iteration losses and OCE
    terms bit-equal, and the same final weights."""
    states = {k: _run(one_crop_container, tmp_path / f"k{k}", steps_per_dispatch=k,
                      **MODES[mode]) for k in (1, 3)}
    for key in ("loss", "oce_loss"):
        assert states[3]["logger_data"][key] == states[1]["logger_data"][key]
    assert len(states[3]["logger_data"]["loss"]) == 6
    assert states[3]["iteration"] == states[1]["iteration"] == 5
    for name, value in states[1]["model_state_dict"].items():
        assert torch.equal(states[3]["model_state_dict"][name], value), name


def test_chunks_equal_single_steps_3d(blob_container_3d, tmp_path):
    """3D, device pairs: K = 2 and K = 1 bit-equal."""
    model = {**MODEL, "downsampling_factors": [[1, 2, 2]]}
    states = {}
    for k in (1, 2):
        config = ExperimentConfig(**{
            **_train_dict(blob_container_3d, device="cpu", crop_size=[20, 36, 36], kappa=3.0,
                          density=0.1, pair_count_mode="all_dims", max_iterations=4,
                          device_pair_sampling=True, steps_per_dispatch=k),
            "object_size": 8, "model_config": model})
        os.makedirs(tmp_path / f"k{k}")
        cwd = os.getcwd()
        os.chdir(tmp_path / f"k{k}")
        try:
            states[k] = cellulus_tpu_torch.train(config)
        finally:
            os.chdir(cwd)
    assert states[2]["logger_data"]["loss"] == states[1]["logger_data"]["loss"]
    assert len(states[2]["logger_data"]["loss"]) == 4


def test_chunks_match_jax(blob_container_2d, tmp_path, monkeypatch):
    """Host pairs (the numpy stream both packages draw), K = 2 in both, from
    one .pth: loss.csv rows at rtol 1e-5 (as ``test_host_pair_options_match_jax``)
    and the same checkpoints, cadence actions falling at chunk ends."""
    spec = UNetSpec(1, 2, 8, 2, 16, ((2, 2),), 2)
    start = tmp_path / "start.pth"
    save_torch_checkpoint(start, init_params(jax.random.PRNGKey(0), spec), iteration=-1,
                          logger_data={"loss": [], "oce_loss": []})
    overrides = dict(steps_per_dispatch=2, max_iterations=5, save_model_every=3,
                     save_best_model_every=2, save_snapshot_every=1000)
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_config = JaxExperimentConfig(**_train_dict(blob_container_2d, **overrides))
    jax_config.model_config.checkpoint = str(start)
    cellulus_tpu.train(jax_config)
    state = _run(blob_container_2d, tmp_path / "port", str(start), **overrides)
    _, want = _csv(tmp_path / "jax" / "loss.csv")
    _, got = _csv(tmp_path / "port" / "loss.csv")
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert state["iteration"] == 4
    # saves at 0, 3 and the last iteration land on the chunk ends 1, 3 and 4
    assert sorted(os.listdir(tmp_path / "port" / "models")) == [
        "000001.pth", "000003.pth", "000004.pth", "best_loss.pth"]
    assert sorted(p.name for p in (tmp_path / "jax" / "models").glob("0*.ckpt")) == [
        "000001.ckpt", "000003.ckpt", "000004.ckpt"]


def test_checkpoint_at_the_chunk_boundary(one_crop_container, tmp_path):
    """The mirror of ``tests/test_train_loop.py:357``: with K = 3 a save at
    iteration 4 lands at the chunk boundary 5, holding the parameters after
    iteration 5 of an uninterrupted 6-step run."""
    full = _run(one_crop_container, tmp_path / "full", steps_per_dispatch=3,
                device_pair_sampling=True)
    _run(one_crop_container, tmp_path / "saved", steps_per_dispatch=3,
         device_pair_sampling=True, save_model_every=4)
    names = sorted(p.name for p in (tmp_path / "saved" / "models").glob("0*.pth"))
    assert "000005.pth" in names and "000004.pth" not in names, names
    saved = torch.load(tmp_path / "saved" / "models" / "000005.pth", weights_only=True)
    assert saved["iteration"] == 5
    for name, value in full["model_state_dict"].items():
        assert torch.equal(saved["model_state_dict"][name], value), name


def test_grad_norm_rows_and_the_tail_chunk(one_crop_container, tmp_path):
    """7 iterations at K = 3: chunks of 3, 3 and a tail of 1. ``grad_norm``
    is NaN but on each chunk's last row, where it equals the K = 1 run's."""
    for k in (1, 3):
        _run(one_crop_container, tmp_path / f"k{k}", steps_per_dispatch=k, max_iterations=7,
             device_pair_sampling=True, log_grad_norm=True)
    header, rows = _csv(tmp_path / "k3" / "loss.csv")
    _, single = _csv(tmp_path / "k1" / "loss.csv")
    assert header[1:] == ["loss", "oce_loss", "grad_norm"]
    assert len(rows) == len(single) == 7
    norms = np.asarray(rows)[:, 2]
    last_rows = [2, 5, 6]
    assert np.isnan(np.delete(norms, last_rows)).all()
    np.testing.assert_array_equal(norms[last_rows], np.asarray(single)[last_rows, 2])
    np.testing.assert_array_equal(np.asarray(rows)[:, :2], np.asarray(single)[:, :2])


@pytest.mark.parametrize("first,second", [(3, 1), (1, 3)])
def test_resume_across_k(one_crop_container, tmp_path, first, second):
    """A checkpoint written at one K resumes at another: the resumed run's
    losses and weights equal an uninterrupted K = 1 run's (device pairs draw
    from (seed + 17, iteration))."""
    full = _run(one_crop_container, tmp_path / "full", max_iterations=6,
                device_pair_sampling=True)
    part = _run(one_crop_container, tmp_path / "part", steps_per_dispatch=first,
                max_iterations=3, device_pair_sampling=True)
    assert part["iteration"] == 2
    resumed = _run(one_crop_container, tmp_path / "part",
                   str(tmp_path / "part" / "models" / "000002.pth"),
                   steps_per_dispatch=second, max_iterations=6, device_pair_sampling=True)
    assert resumed["iteration"] == 5
    assert resumed["logger_data"]["loss"] == full["logger_data"]["loss"]
    for name, value in full["model_state_dict"].items():
        assert torch.equal(resumed["model_state_dict"][name], value), name


def test_milestone_inside_a_chunk(one_crop_container, tmp_path):
    """A milestone at step 4 falls inside the chunk [3, 5] of K = 3: every
    step's rate equals K = 1's, so every loss does."""
    states = {k: _run(one_crop_container, tmp_path / f"k{k}", steps_per_dispatch=k,
                      device_pair_sampling=True, lr_milestones=[4], lr_decay_factor=0.1)
              for k in (1, 3)}
    assert states[3]["logger_data"]["loss"] == states[1]["logger_data"]["loss"]
    plain = _run(one_crop_container, tmp_path / "plain", steps_per_dispatch=3,
                 device_pair_sampling=True)
    # the decay shows from the step after the milestone on
    assert plain["logger_data"]["loss"][:5] == states[3]["logger_data"]["loss"][:5]
    assert plain["logger_data"]["loss"][5] != states[3]["logger_data"]["loss"][5]


def test_rate_on_device_follows_the_schedule():
    """The rate a captured step computes from Adam's step count (a tensor)
    is :meth:`learning_rate_at` of that count, rounded to float32."""
    w = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([w], 3e-4, lr_milestones=[2, 5, 5, 9], lr_decay_factor=0.3)
    for count in range(12):
        got = opt.rate_on_device(torch.tensor(float(count)))
        assert got.dtype == torch.float32
        assert float(got) == float(np.float32(opt.learning_rate_at(count))), count


def test_dense_chunks_raise(one_crop_container, tmp_path):
    with pytest.raises(NotImplementedError, match="offs.tolist"):
        _run(one_crop_container, tmp_path, steps_per_dispatch=2, loss_mode="dense")
