"""Data-parallel training of the port (``parallel/distributed.py``) against
the JAX package, on the CPU in gloo groups of 2 ranks.

- A step on 2 ranks, each on its half of one global batch, against the JAX
  package's single-device step on the whole batch (pairs, grid, dense),
  at ``tests/test_parallel.py``'s tolerances; the draws of grid and dense
  are the global batch's, from the JAX step's key splits.
- Gradients are summed over the ranks, not averaged: 2 ranks equal one
  rank on the whole batch where a mean would not (a weight decay as large
  as the gradient; a clip norm between half the gradient's norm and its
  norm).
- ``train()`` in 2 processes, as ``tests/test_distributed.py`` runs the JAX
  package's: one rank in a group its caller formed, the other forming it
  from ``torchrun``'s environment; both finish, only the primary prints
  and writes, and each rank's crops are the JAX dataset's at ``seed +
  10007 * rank``. Then ``data_parallelism = 2`` spawning its own ranks.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cellulus_tpu_torch
from cellulus_tpu.configs import ExperimentConfig as JaxExperimentConfig
from cellulus_tpu.datasets import BatchLoader as JaxBatchLoader
from cellulus_tpu.datasets import get_dataset as jax_get_dataset
from cellulus_tpu.datasets.sampling import PairSampler as JaxPairSampler
from cellulus_tpu.models import compute_geometry as jax_compute_geometry
from cellulus_tpu.train import make_optimizer as jax_make_optimizer
from cellulus_tpu.train import make_train_step as jax_make_train_step
from cellulus_tpu.train import make_train_step_dense as jax_make_train_step_dense
from cellulus_tpu.train import make_train_step_grid as jax_make_train_step_grid
from cellulus_tpu_torch.configs import ExperimentConfig
from cellulus_tpu_torch.models import state_dict_from_jax_params
from cellulus_tpu_torch.parallel import distributed as dist
from cellulus_tpu_torch.train import grid_layout
from tests.torch_dp_worker import REG, TEMPERATURE, rank_main, run_case
from tests.unet_pairs import unet_pair

REPO = Path(__file__).resolve().parents[1]
LR = 4e-5
BATCH, CROP, KAPPA, DENSITY = 4, 52, 6.0, 0.1
MODEL = dict(in_channels=1, out_channels=2, num_fmaps=8, fmap_inc_factor=2,
             features_in_last_layer=16, downsampling_factors=[[2, 2]], num_spatial_dims=2)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the cases are small, and test workers run side
    by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _draws(mode, key, sampler, out):
    """The global batch's draws of the JAX step, from its own key splits
    (``cellulus_tpu/train.py:276-283`` for dense, ``:370-386`` for grid)."""
    table = np.asarray(sampler._offsets)
    if mode == "grid":
        stride, grid_dims, A, _ = grid_layout(sampler)
        k_j, k_off = jax.random.split(key)
        jitter = jax.random.randint(k_j, (len(out),), 0, stride)
        idx = jax.random.randint(k_off, (BATCH, A, sampler.n_references), 0, table.shape[0])
        return (torch.from_numpy(np.asarray(jitter).astype(np.int64)),
                torch.from_numpy(np.asarray(idx).astype(np.int64)))
    k = int(sampler.kappa)
    unbiased = tuple(s - 2 * k for s in out)
    rate = min(1.0, sampler.n_anchors / float(np.prod(unbiased)))
    k_off, k_mask = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k_off, (sampler.n_references,), 0, table.shape[0]))
    mask = np.asarray(jax.random.bernoulli(k_mask, rate, (BATCH, *unbiased)))
    return torch.from_numpy(table[idx].astype(np.int64)), torch.from_numpy(mask.astype(np.float32))


def _case(mode, optimizer=None, jax_step=True):
    """A global batch, the JAX single-device step's result on it (None
    without ``jax_step``), and the case the port's ranks run."""
    spec, params, model = unet_pair(2, [[2, 2]])
    out = tuple(jax_compute_geometry((CROP, CROP), spec.downsampling_factors).output_size)
    sampler = JaxPairSampler(out, density=DENSITY, kappa=KAPPA)
    rng = np.random.default_rng(5)
    raw = rng.random((BATCH, CROP, CROP, 1)).astype(np.float32)
    case = dict(mode=mode, model=MODEL, state_dict=model.state_dict(), lr=LR,
                optimizer=optimizer or {}, raw=raw, out=out, density=DENSITY, kappa=KAPPA)
    opt = jax_make_optimizer(LR, **(optimizer or {}))
    state = opt.init(params)
    if mode == "pairs":
        pairs = [sampler.sample(rng) for _ in range(BATCH)]
        case["anchors"] = np.stack([a for a, _ in pairs])
        case["references"] = np.stack([r for _, r in pairs])
        if not jax_step:
            return case, None
        step = jax.jit(jax_make_train_step(spec, opt, TEMPERATURE, REG))
        params, _, loss, oce, _ = step(params, state, jnp.asarray(raw),
                                       jnp.asarray(case["anchors"]),
                                       jnp.asarray(case["references"]))
    else:
        make = {"grid": jax_make_train_step_grid, "dense": jax_make_train_step_dense}[mode]
        step = jax.jit(make(spec, opt, TEMPERATURE, REG, sampler, BATCH))
        key = jax.random.PRNGKey(3)
        case["draws"] = _draws(mode, key, sampler, out)
        params, _, loss, oce, _ = step(params, state, jnp.asarray(raw), key)
    want = dict(loss=float(loss), oce=float(oce),
                params=state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return case, want


# name: (mode, optimizer arguments, held against the JAX step)
CASES = {"pairs": ("pairs", None, True), "grid": ("grid", None, True),
         "dense": ("dense", None, True),
         # a decay term as large as the gradient: a mean would halve the
         # gradient against it
         "weight_decay": ("pairs", {"weight_decay": 200.0}, False)}


@pytest.fixture(scope="module")
def two_ranks():
    """Every case's JAX result, and the port's on 2 gloo ranks (one spawn)."""
    cases, wants = {}, {}
    for name, (mode, optimizer, jax_step) in CASES.items():
        cases[name], wants[name] = _case(mode, optimizer, jax_step)
    # a clip norm between half the global gradient's norm and its norm:
    # the global norm clips, half of it (a mean) would not
    case = dict(cases["pairs"])
    norm = run_case(case, False, slice(None))[3]
    cases["grad_clip_norm"] = dict(case, optimizer={"grad_clip_norm": 0.75 * norm})
    return cases, wants, dist.spawn(rank_main, 2, "cpu", cases)


@pytest.mark.parametrize("name", ["pairs", "grid", "dense"])
def test_data_parallel_step_matches_jax(two_ranks, name):
    """Loss at rtol 1e-5 and parameters at rtol 2e-4, atol 1e-6
    (``tests/test_parallel.py:50-60``); both ranks hold the same
    parameters."""
    _, wants, got = two_ranks
    got, want = got[name], wants[name]
    assert got["spread"] == 0.0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["oce"], want["oce"], rtol=1e-5)
    for n, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), want["params"][n].numpy(), rtol=2e-4, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("name", ["weight_decay", "grad_clip_norm"])
def test_gradients_are_summed_over_ranks(two_ranks, name):
    """2 ranks on halves equal one rank on the whole batch: the loss, the
    gradient norm (taken after the reduce) and every parameter."""
    cases, _, got = two_ranks
    loss, oce, params, grad_norm = run_case(cases[name], False, slice(None))
    got = got[name]
    assert got["spread"] == 0.0
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], grad_norm, rtol=1e-5)
    for n, p in params.items():
        np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=n)


WORKER = r"""
import json, os, sys
rank, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.chdir(workdir)
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
import torch.distributed as tdist
import cellulus_tpu_torch.train as train_mod
from cellulus_tpu_torch.configs import ExperimentConfig
from tests.torch_dp_worker import crops_of
train_mod.BatchLoader = crops_of(train_mod.BatchLoader, rank)
if rank == 0:
    # a group the caller formed: train() runs in it
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}", world_size=2,
                             rank=0)
else:
    # torchrun's environment: train() forms the group
    os.environ.update(WORLD_SIZE="2", RANK="1", LOCAL_RANK="1", MASTER_ADDR="localhost",
                      MASTER_PORT=port)
state = train_mod.train(ExperimentConfig(**json.load(open("config.json"))))
print("WORKER_DONE", rank, repr(float(state["lowest_loss"])))
"""


def _config(container, steps_per_dispatch, **overrides):
    train = dict(crop_size=[48, 48], batch_size=2, max_iterations=3, elastic_deform=False,
                 num_workers=0, save_model_every=100, save_snapshot_every=2,
                 save_best_model_every=2, loss_mode="grid", steps_per_dispatch=steps_per_dispatch,
                 train_data_config={"container_path": str(container), "dataset_name": "train"},
                 validate_data_config={"container_path": str(container),
                                       "dataset_name": "train"})
    train.update(overrides)
    return {"object_size": 10, "train_config": train,
            "model_config": {"num_fmaps": 6, "fmap_inc_factor": 2, "features_in_last_layer": 8,
                             "downsampling_factors": [[2, 2]]}}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_crops(config, rank):
    """The first batch of the JAX package's dataset at ``seed + 10007 *
    rank``, built as ``cellulus_tpu/train.py`` builds it, loaded a rank's
    share at a time."""
    train = {k: v for k, v in config["train_config"].items() if k != "device"}
    jc = JaxExperimentConfig(**{**config, "train_config": train})
    tc = jc.train_config
    geometry = jax_compute_geometry(tuple(tc.crop_size), jc.model_config.downsampling_factors)
    dataset = jax_get_dataset(
        dataset_config=tc.train_data_config, crop_size=tuple(tc.crop_size),
        elastic_deform=tc.elastic_deform, control_point_spacing=tc.control_point_spacing,
        control_point_jitter=tc.control_point_jitter, density=tc.density, kappa=tc.kappa,
        normalization_factor=jc.normalization_factor, output_shape=geometry.output_size,
        seed=tc.seed + 10007 * rank, sample_pairs=False, pair_count_mode=tc.pair_count_mode)
    with JaxBatchLoader(dataset, tc.batch_size // 2, num_workers=tc.num_workers) as loader:
        return next(iter(loader))[0]


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_two_rank_training_run(blob_container_2d, tmp_path, steps_per_dispatch):
    """K = 1 steps one at a time; K = 2 in chunks, with a ragged last chunk
    at max_iterations = 3 (``tests/test_distributed.py:110-160``)."""
    config = _config(blob_container_2d, steps_per_dispatch, device="cpu")
    (tmp_path / "config.json").write_text(json.dumps(config))
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["CELLULUS_TPU_NO_PROGRESS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", WORKER.format(repo=str(REPO)), str(rank),
                               port, str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for rank in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        assert f"WORKER_DONE {rank}" in out, out[-2000:]
    # the loss is the global batch's: both ranks hold the same lowest loss
    lowest = [out.split(f"WORKER_DONE {rank} ")[1].split()[0] for rank, out in enumerate(outs)]
    assert lowest[0] == lowest[1]
    # only the primary prints, validates, checkpoints and snapshots
    assert "===> iteration: 0" in outs[0] and "===> iteration:" not in outs[1]
    assert "===> validation loss:" in outs[0] and "===> validation loss:" not in outs[1]
    assert "Checkpoint saved" not in outs[1] and '"train_config"' not in outs[1]
    assert (tmp_path / "snapshots.zarr").exists()
    rows = (tmp_path / "loss.csv").read_text().splitlines()
    assert len(rows) == 4  # the header and 3 iterations, written once
    state = torch.load(tmp_path / "models" / "000002.pth", weights_only=True)
    assert state["iteration"] == 2
    for rank in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"crops_rank{rank}.npy"),
                                      _jax_crops(config, rank), err_msg=f"rank {rank}")


def test_data_parallelism_spawns_its_ranks(blob_container_2d, tmp_path, monkeypatch):
    """``data_parallelism = 2`` outside a group: train() spawns 2 gloo ranks
    on the CPU and returns the primary's state; the files are written once."""
    monkeypatch.chdir(tmp_path)
    state = cellulus_tpu_torch.train(ExperimentConfig(**_config(
        blob_container_2d, 1, device="cpu", data_parallelism=2, validate_data_config=None)))
    assert state["iteration"] == 2 and len(state["logger_data"]["loss"]) == 3
    assert sorted(os.listdir("models")) == ["000000.pth", "000002.pth", "best_loss.pth"]
    assert len(Path("loss.csv").read_text().splitlines()) == 4


def test_uneven_batch_in_a_group_raises(blob_container_2d, tmp_path, monkeypatch):
    """In a group of 2 ranks, a batch of 3 does not split: train() raises the
    JAX package's ``local_batch_size`` ValueError before any step (the group
    is stood in for; nothing reaches a collective)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(dist, "in_group", lambda: True)
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "process_index", lambda: 0)
    config = ExperimentConfig(**_config(blob_container_2d, 1, device="cpu", batch_size=3))
    with pytest.raises(ValueError, match="batch_size 3 is not divisible by the process count 2"):
        cellulus_tpu_torch.train(config)
