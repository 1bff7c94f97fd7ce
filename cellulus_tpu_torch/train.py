"""Training runtime: crops + pair sampling -> U-Net -> OCE loss -> Adam.

Port of ``cellulus_tpu/train.py`` on one device with
``steps_per_dispatch=1`` (``train.py:646-1253``), 2D and 3D. Each step runs
the U-Net's training path (in 2D every 3x3 filter gradient through kernel
K2 on the card; in 3D library convolutions, as in the JAX package),
gathers the anchor and reference embeddings, takes the OCE loss, and
updates with Adam whose L2 decay enters the gradient before the moments.
Host work (crops, elastic warp, pair sampling with device sampling off)
overlaps the device through the threaded batch loader, and the loss is
fetched one step late so the host does not wait for the step in flight.
Checkpoints are reference-format ``.pth`` files that ``infer`` reads.

Options of the JAX package that are not on this path raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import os
import sys
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .configs import ExperimentConfig
from .criterions import oce_loss
from .datasets import BatchLoader, ConcatDataset, get_dataset
from .io import zarr
from .models import (
    compute_geometry,
    init_unet_,
    load_state_dict,
    select_and_add_coordinates,
    unet_from_config,
)
from .utils.checkpoint import checkpoint_path, load_train_state, save_checkpoint, train_state
from .utils.device import compute_dtype_for, resolve_device, seeded_generator
from .utils.logger import get_logger


class TrainOptimizer:
    """The JAX package's optax chain (``train.py:57-110``) on
    ``torch.optim.Adam``.

    Per step: the raw gradient's global norm (kept in ``grad_norm`` when
    logged), ``clip_grad_norm_`` when ``grad_clip_norm`` is set, then Adam
    with ``weight_decay`` added to the gradient before the moments (torch
    Adam-with-L2, not AdamW). With ``lr_milestones`` the learning rate is
    ``learning_rate * lr_decay_factor ** (milestones <= count)``, ``count``
    the updates applied before this one (optax ``scale_by_schedule``); the
    count is Adam's own step state, so it survives a resume.
    """

    def __init__(
        self,
        params,
        learning_rate: float,
        weight_decay: float = 0.01,
        lr_milestones=None,
        lr_decay_factor: float = 0.1,
        grad_clip_norm: Optional[float] = None,
        log_grad_norm: bool = False,
    ):
        self.params = list(params)
        self.hyper = dict(lr=float(learning_rate), betas=(0.9, 0.999), eps=1e-8,
                          weight_decay=float(weight_decay))
        self.adam = torch.optim.Adam(self.params, **self.hyper)
        self.milestones = sorted(int(m) for m in lr_milestones or ())
        self.lr_decay_factor = float(lr_decay_factor)
        self.grad_clip_norm = grad_clip_norm
        self.log_grad_norm = log_grad_norm
        self.grad_norm: Optional[torch.Tensor] = None

    @property
    def count(self) -> int:
        state = self.adam.state.get(self.params[0])
        return int(state["step"]) if state else 0

    def learning_rate_at(self, count: int) -> float:
        passed = sum(count >= m for m in self.milestones)
        return self.hyper["lr"] * self.lr_decay_factor**passed

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.grad_clip_norm is not None:
            self.grad_norm = torch.nn.utils.clip_grad_norm_(self.params, self.grad_clip_norm)
        elif self.log_grad_norm:
            norms = [torch.linalg.vector_norm(p.grad) for p in self.params if p.grad is not None]
            self.grad_norm = torch.linalg.vector_norm(torch.stack(norms))
        if self.milestones:
            lr = self.learning_rate_at(self.count)
            for group in self.adam.param_groups:
                group["lr"] = lr
        self.adam.step()

    def state_dict(self) -> Dict[str, Any]:
        return self.adam.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore the moments and the step count; the hyper-parameters
        stay this run's, as the JAX package rebuilds its chain from the
        config and restores only the state arrays."""
        self.adam.load_state_dict(state)
        for group in self.adam.param_groups:
            group.update(self.hyper)


def make_optimizer(
    params,
    learning_rate: float,
    weight_decay: float = 0.01,
    lr_milestones=None,
    lr_decay_factor: float = 0.1,
    grad_clip_norm=None,
    log_grad_norm: bool = False,
) -> TrainOptimizer:
    return TrainOptimizer(params, learning_rate, weight_decay, lr_milestones,
                          lr_decay_factor, grad_clip_norm, log_grad_norm)


def make_train_step(model, optimizer, temperature: float, regularizer_weight: float,
                    compute_dtype=torch.float32):
    """Step with host pairs in the repeated-anchor layout: ``step(raw (B,
    *spatial, C), anchors (B, P, D), references (B, P, D)) -> (loss, oce,
    offsets)``, all detached; the parameters are updated in place."""

    def step(raw, anchors, references):
        optimizer.zero_grad()
        offsets = model(raw, compute_dtype)
        e_anchor = select_and_add_coordinates(offsets, anchors)
        e_reference = select_and_add_coordinates(offsets, references)
        loss, oce, _ = oce_loss(e_anchor, e_reference, temperature, regularizer_weight)
        loss.backward()
        optimizer.step()
        return loss.detach(), oce.detach(), offsets.detach()

    return step


def make_train_step_fused(model, optimizer, temperature: float, regularizer_weight: float,
                          pair_sampler, batch_size: int, compute_dtype=torch.float32,
                          device="cpu"):
    """Step with pairs drawn on the device: ``step(raw, generator) -> (loss,
    oce, offsets)``. Each anchor embedding is gathered once and broadcast
    over its R references, which are gathered from the detached offsets
    (``train.py:186-206``): the same loss as the repeated-anchor layout."""
    sample = pair_sampler.device_sampler_grouped(device)

    def step(raw, generator):
        anchors, references = sample(generator, batch_size)
        B, A, R, D = references.shape
        optimizer.zero_grad()
        offsets = model(raw, compute_dtype)
        e_anchor = select_and_add_coordinates(offsets, anchors)
        e_reference = select_and_add_coordinates(
            offsets.detach(), references.reshape(B, A * R, D)
        ).reshape(B, A, R, D)
        loss, oce, _ = oce_loss(
            e_anchor[:, :, None, :].expand(B, A, R, D), e_reference,
            temperature, regularizer_weight,
        )
        loss.backward()
        optimizer.step()
        return loss.detach(), oce.detach(), offsets.detach()

    return step


def save_snapshot(raw_b, prediction_b, iteration: int, path="snapshots.zarr",
                  axis_names=None) -> None:
    """Write raw + mean-centred prediction (reference ``train.py:194-224``).

    Args:
        raw_b: ``(B, C, *spatial)`` numpy batch.
        prediction_b: ``(B, D, *spatial_out)`` numpy predictions.
        axis_names: spatial axis names of the training dataset; z/y/x when
            None.
    """
    num_spatial_dims = raw_b.ndim - 2
    if axis_names is None or len(axis_names) != num_spatial_dims:
        axis_names = ["t", "z", "y", "x"][-num_spatial_dims:]
    axis_names = ["s", "c"] + list(axis_names)
    offset = tuple(
        (a - b) / 2
        for a, b in zip(raw_b.shape[-num_spatial_dims:], prediction_b.shape[-num_spatial_dims:])
    )
    f = zarr.open(path, "a")
    f[f"{iteration}/raw"] = raw_b
    f[f"{iteration}/raw"].attrs.update(
        {"axis_names": axis_names, "resolution": [1] * num_spatial_dims}
    )
    pred = np.asarray(prediction_b, dtype=np.float32)
    mean = pred.reshape(pred.shape[0], pred.shape[1], -1).mean(axis=2)
    pred = pred - mean[(...,) + (np.newaxis,) * num_spatial_dims]
    f[f"{iteration}/prediction"] = pred
    f[f"{iteration}/prediction"].attrs.update(
        {"axis_names": axis_names, "offset": list(offset),
         "resolution": [1] * num_spatial_dims}
    )


def check_3d_density_envelope(
    num_spatial_dims: int,
    density: float,
    pair_count_mode: str = "reference",
    lr: float = 4e-4,
) -> None:
    """Warn when a 3D run leaves the validated lr x pair-density envelope.

    A copy of ``cellulus_tpu/train.py:check_3d_density_envelope``, with its
    texts and thresholds.

    2D's default ``density = 0.1`` is NOT a safe 3D default *at the default
    lr*: on 3D volumes the embedding degrades or collapses when the learning
    rate and the pair density are jointly too large. The round-4 lr x density
    grid (docs/validation.md) shows the boundary is their PRODUCT, not the
    density alone: every measured cell with ``lr * density <= 2e-5`` scores
    F1 >= 0.91 — including density 0.1 (the 2D default) once lr drops to
    1e-4, which scores F1 1.0 — while every cell above scores <= 0.52 and
    high-lr cells collapse outright (F1 0.009 at lr 1.6e-3, density 0.025).
    Below ``density ~0.02`` pair starvation collapses training regardless of
    lr. The reference's pair count uses only the first two spatial dims even
    in 3D (reference ``datasets/zarr_dataset.py:244-248``), which makes its
    3D pair budget erratic — this guard is a deviation in the user's favor.
    """
    if num_spatial_dims < 3:
        return
    if density < 0.02 - 1e-9:
        warnings.warn(
            f"3D training with density={density:g} is below the validated "
            "envelope: pair starvation collapses training (density 0.0125 "
            "scored F1 0.085 in the docs/validation.md sweep). Set "
            "train_config.density in [0.025, 0.05] with "
            'pair_count_mode = "all_dims".',
            RuntimeWarning,
            stacklevel=3,
        )
    elif lr * density > 2e-5 + 1e-12:
        warnings.warn(
            f"3D training with lr={lr:g} and density={density:g} "
            f"(lr*density={lr * density:.2g}) is outside the validated "
            "envelope: in the docs/validation.md lr x density grid every "
            "cell with lr*density > 2e-5 scores F1 <= 0.52 (e.g. density "
            "0.1 scores F1 0.48 at lr 4e-4 but F1 1.0 at lr 1e-4), every "
            "cell at <= 1e-5 scores F1 >= 0.91, and the 2e-5 boundary "
            "itself is run-to-run noisy. Lower train_config.learning_rate "
            "or train_config.density so their product is <= 1e-5, with "
            'pair_count_mode = "all_dims".',
            RuntimeWarning,
            stacklevel=3,
        )
    elif pair_count_mode == "reference":
        warnings.warn(
            '3D training with pair_count_mode="reference" counts pairs with '
            "the reference's 2-dim formula (reference "
            "zarr_dataset.py:244-248), giving an unintentionally small and "
            'crop-shape-dependent pair budget in 3D; "all_dims" is the '
            "validated 3D setting (docs/validation.md).",
            RuntimeWarning,
            stacklevel=3,
        )


def _check_ported(train_config) -> None:
    """Raise for the JAX package's options that are not ported yet."""
    unported = [
        (train_config.loss_mode != "pairs", f"loss_mode={train_config.loss_mode!r}"),
        (train_config.steps_per_dispatch > 1, "steps_per_dispatch > 1"),
        (train_config.elastic_on_device, "elastic_on_device"),
        (train_config.transfer_precision == "native", "transfer_precision='native'"),
        (train_config.remat, "remat"),
        (train_config.packed_dw, "packed_dw"),
    ]
    for on, what in unported:
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP: M9, train variants)"
            )
    if (train_config.data_parallelism or 1) > 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "data-parallel and multi-process training are not ported yet "
            "(ROADMAP: M13, multi-GPU)"
        )


def train(experiment_config: ExperimentConfig,
          step_times: Optional[List[float]] = None) -> Dict[str, Any]:
    """Run training as configured; return the final state (the checkpoint's
    keys). ``step_times``, when given, receives the host clock at each
    iteration's loss fetch (each fetch waits for that step's device work)."""
    print(experiment_config)
    train_config = experiment_config.train_config
    model_config = experiment_config.model_config
    _check_ported(train_config)
    device = resolve_device(train_config.device)
    compute_dtype = compute_dtype_for(train_config.precision)
    if train_config.precision == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs("models", exist_ok=True)

    crop_size = tuple(train_config.crop_size)
    geometry = compute_geometry(crop_size, model_config.downsampling_factors)

    def build_dataset(dataset_config):
        return get_dataset(
            dataset_config=dataset_config,
            crop_size=crop_size,
            elastic_deform=train_config.elastic_deform,
            control_point_spacing=train_config.control_point_spacing,
            control_point_jitter=train_config.control_point_jitter,
            density=train_config.density,
            kappa=train_config.kappa,
            normalization_factor=experiment_config.normalization_factor,
            output_shape=geometry.output_size,
            seed=train_config.seed,
            sample_pairs=not train_config.device_pair_sampling,
            pair_count_mode=train_config.pair_count_mode,
        )

    if train_config.train_data_configs:
        dataset = ConcatDataset([build_dataset(c) for c in train_config.train_data_configs])
    else:
        dataset = build_dataset(train_config.train_data_config)
    num_spatial_dims = dataset.get_num_spatial_dims()
    check_3d_density_envelope(num_spatial_dims, train_config.density,
                              train_config.pair_count_mode, lr=train_config.initial_learning_rate)

    # initialize=True: Kaiming-normal conv weights (reference train.py:65-68);
    # False: the torch conv default U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    model = unet_from_config(
        model_config, in_channels=dataset.get_num_channels(), num_spatial_dims=num_spatial_dims
    )
    init_unet_(
        model,
        "kaiming_normal" if model_config.initialize else "torch_default",
        torch.Generator().manual_seed(train_config.seed),
    )
    model.to(device)
    optimizer = make_optimizer(
        model.parameters(),
        train_config.initial_learning_rate,
        lr_milestones=train_config.lr_milestones,
        lr_decay_factor=train_config.lr_decay_factor,
        grad_clip_norm=train_config.grad_clip_norm,
        log_grad_norm=train_config.log_grad_norm,
    )

    logger_keys = ["loss", "oce_loss"]
    if train_config.log_grad_norm:
        logger_keys.append("grad_norm")
    if train_config.validate_data_config is not None:
        logger_keys.append("val_loss")
    logger = get_logger(keys=logger_keys, title="loss")

    start_iteration = 0
    # +inf, not the reference's 1e6 (train.py:89): a config whose early
    # mean loss exceeds 1e6 would otherwise never write best_loss.pth
    lowest_loss = float("inf")
    if model_config.checkpoint is not None:
        print(f"Resuming model from {model_config.checkpoint}")
        state = load_train_state(model_config.checkpoint)
        load_state_dict(model, state["model_state_dict"])
        if state.get("optim_state_dict"):
            optimizer.load_state_dict(state["optim_state_dict"])
        start_iteration = int(state.get("iteration", -1)) + 1
        lowest_loss = float(state.get("lowest_loss", 1e6))
        if state.get("logger_data"):
            logger.data = {k: list(state["logger_data"].get(k, [])) for k in logger.keys}

    def to_device(raw_np):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(raw_np, 1, -1))).to(device)

    # validation: a fixed two-batch set, its loss logged at the best-model
    # cadence (the reference accepts validate_data_config but never uses it)
    val_batches = None
    if train_config.validate_data_config is not None:
        try:
            val_dataset = get_dataset(
                dataset_config=train_config.validate_data_config,
                crop_size=crop_size,
                elastic_deform=False,
                control_point_spacing=train_config.control_point_spacing,
                control_point_jitter=train_config.control_point_jitter,
                density=train_config.density,
                kappa=train_config.kappa,
                normalization_factor=experiment_config.normalization_factor,
                output_shape=geometry.output_size,
                seed=train_config.seed + 999,
            )
            val_iter = val_dataset.iterate(train_config.seed + 999)
            val_batches = []
            for _ in range(2):
                items = [next(val_iter) for _ in range(train_config.batch_size)]
                val_batches.append(tuple(np.stack(f) for f in zip(*items)))
        except zarr.CorruptChunkError:
            raise  # corrupt data must abort, not silently skip validation
        except (FileNotFoundError, KeyError, RuntimeError) as e:
            print(f"validation disabled: {e}")
            val_batches = None

    def validation_loss() -> float:
        total = 0.0
        with torch.no_grad():
            for raw_np, anc_np, ref_np in val_batches:
                offsets = model(to_device(raw_np), compute_dtype)
                e_a = select_and_add_coordinates(offsets, torch.from_numpy(anc_np).to(device))
                e_r = select_and_add_coordinates(offsets, torch.from_numpy(ref_np).to(device))
                total += float(oce_loss(e_a, e_r, train_config.temperature,
                                        train_config.regularizer_weight)[0])
        return total / len(val_batches)

    if train_config.device_pair_sampling:
        step = make_train_step_fused(
            model, optimizer, train_config.temperature, train_config.regularizer_weight,
            dataset.sampler, train_config.batch_size, compute_dtype, device,
        )
    else:
        step = make_train_step(
            model, optimizer, train_config.temperature, train_config.regularizer_weight,
            compute_dtype,
        )

    loader = BatchLoader(dataset, train_config.batch_size, num_workers=train_config.num_workers)

    epoch_loss = 0.0
    num_iterations = 0
    iteration = start_iteration - 1
    pending = None  # (iteration, loss, oce[, grad_norm]) of the step in flight

    def consume(entry):
        nonlocal epoch_loss, num_iterations
        it, loss_t, oce_t = entry[:3]
        loss_f, oce_f = float(loss_t), float(oce_t)
        if step_times is not None:
            step_times.append(time.perf_counter())
        print(f"===> iteration: {it}, loss: {loss_f:.6f}, oce loss: {oce_f:.6f}")
        logger.add("loss", loss_f)
        logger.add("oce_loss", oce_f)
        if len(entry) > 3:
            logger.add("grad_norm", float(entry[3]))
        logger.step()
        epoch_loss += loss_f
        num_iterations += 1

    def save(iteration: int, is_lowest: bool = False) -> None:
        save_checkpoint(
            checkpoint_path(iteration, is_lowest),
            train_state(iteration, lowest_loss, model, optimizer, logger.data),
        )

    def cadence_actions(iteration, offsets, raw_np, do_best=None, do_ckpt=None,
                        do_snapshot=None):
        """Best-model / checkpoint / snapshot handling (``train.py:1034-1119``)."""
        nonlocal epoch_loss, num_iterations, lowest_loss
        if do_best is None:
            do_best = iteration % train_config.save_best_model_every == 0
        if do_ckpt is None:
            do_ckpt = (
                iteration % train_config.save_model_every == 0
                or iteration == train_config.max_iterations - 1
            )
        if do_snapshot is None:
            do_snapshot = iteration % train_config.save_snapshot_every == 0
        if do_best:
            if val_batches is not None:
                val_loss = validation_loss()
                logger.add("val_loss", val_loss)
                print(f"===> validation loss: {val_loss:.6f}")
            mean_loss = epoch_loss / num_iterations
            if mean_loss < lowest_loss:
                lowest_loss = mean_loss
                save(iteration, is_lowest=True)
                print(f"Best model weights saved at iteration {iteration}")
            epoch_loss = 0.0
            num_iterations = 0
        if do_ckpt:
            save(iteration)
            print(f"Checkpoint saved at iteration {iteration}")
        if do_snapshot and offsets is not None:
            meta = getattr(dataset, "meta", None)
            spatial_names = (
                [n for n in meta.axis_names if n not in ("s", "c")] if meta is not None else None
            )
            save_snapshot(raw_np, np.moveaxis(offsets.cpu().numpy(), -1, 1), iteration,
                          axis_names=spatial_names)

    # graceful stop: touching `stop_file` (relative to the working directory)
    # checkpoints the in-hand state and ends the loop. Only a file touched
    # after this moment counts; an older one is ignored, never deleted (the
    # 1 s margin absorbs coarse-mtime filesystems).
    stop_path = Path(train_config.stop_file) if train_config.stop_file else None
    stop_epoch = time.time() - 1.0
    if stop_path is not None and stop_path.exists():
        warnings.warn(
            f"stop file {stop_path} predates this run and is ignored; "
            "touch it again to request a graceful stop"
        )
        stop_epoch = max(stop_epoch, stop_path.stat().st_mtime + 1e-3)

    def stop_requested() -> bool:
        if stop_path is None:
            return False
        try:
            return stop_path.stat().st_mtime >= stop_epoch
        except OSError:
            return False

    with loader:
        batches = iter(loader)
        for iteration in range(start_iteration, train_config.max_iterations):
            batch = next(batches)
            raw_np = batch[0]
            raw = to_device(raw_np)
            if train_config.device_pair_sampling:
                generator = seeded_generator(device, train_config.seed + 17, iteration)
                loss, oce, offsets = step(raw, generator)
            else:
                anchors = torch.from_numpy(batch[1]).to(device)
                references = torch.from_numpy(batch[2]).to(device)
                loss, oce, offsets = step(raw, anchors, references)

            if pending is not None:
                consume(pending)
            pending = (iteration, loss, oce) + (
                (optimizer.grad_norm,) if train_config.log_grad_norm else ()
            )
            is_ckpt = (
                iteration % train_config.save_model_every == 0
                or iteration == train_config.max_iterations - 1
            )
            is_cadence = (
                is_ckpt
                or iteration % train_config.save_best_model_every == 0
                or iteration % train_config.save_snapshot_every == 0
            )
            if is_cadence:
                consume(pending)
                pending = None
                cadence_actions(iteration, offsets, raw_np)
            if stop_requested():
                if pending is not None:
                    consume(pending)
                    pending = None
                cadence_actions(iteration, None, raw_np, do_best=False,
                                do_ckpt=not is_ckpt, do_snapshot=False)
                print(f"Stop file {stop_path} found: checkpointed at iteration "
                      f"{iteration}, exiting the training loop")
                break

    logger.close()
    return train_state(iteration, lowest_loss, model, optimizer, logger.data)


# Callable module: keeps `cellulus_tpu_torch.train(config)` working after an
# `import cellulus_tpu_torch.train` rebinds the package attribute to this module.
class _CallableModule(type(sys.modules[__name__])):
    def __call__(self, experiment_config, step_times=None):
        return train(experiment_config, step_times)


sys.modules[__name__].__class__ = _CallableModule
