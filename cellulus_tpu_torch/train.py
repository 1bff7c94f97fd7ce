"""Training runtime: crops + pair sampling -> U-Net -> OCE loss -> Adam.

Port of ``cellulus_tpu/train.py`` (``train.py:646-1345``), 2D and 3D. Each step runs
the U-Net's training path (in 2D every 3x3 filter gradient through kernel
K2 on the card; in 3D library convolutions, as in the JAX package),
takes the OCE loss of the configured ``loss_mode`` ("pairs" with host or
device pairs, "grid", "dense"), and updates with Adam whose L2 decay
enters the gradient before the moments. Key-driven steps (device pairs,
grid, dense) draw from a ``torch.Generator`` seeded by (seed + 17,
iteration); ``elastic_on_device`` puts the warp in front of them, and
``transfer_precision="native"`` normalizes crops on the device. Host work
(crops, host elastic warp, host pairs) overlaps the device through the
threaded batch loader, and the loss is fetched one step late so the host
does not wait for the step in flight. With ``steps_per_dispatch = K > 1``
the loop runs in chunks of K steps (:class:`StepChunks`), on the card as
one CUDA graph a chunk. Checkpoints are reference-format ``.pth`` files
that ``infer`` reads; a run resumes from one of them or from the JAX
package's ``.ckpt`` (its optax moments mapped onto Adam's).

Data-parallel training (``parallel/distributed.py``) runs one process a
device: under ``torchrun``, in a process group the caller formed, or with
``data_parallelism`` N > 1 (or several visible GPUs), N ranks that
``train()`` spawns itself. Each rank steps on its share of the global
batch; its key-driven draws are the global batch's, of which it keeps its
own rows, and the gradients and loss terms are summed over the ranks.
"""

from __future__ import annotations

import math
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
from .datasets.elastic_device import elastic_deform_batch
from .io import zarr
from .models import (
    adam_moments_from_jax,
    compute_geometry,
    init_unet_,
    load_state_dict,
    select_and_add_coordinates,
    unet_from_config,
)
from .parallel import distributed as dist
from .parallel.mesh import local_devices
from .utils.checkpoint import checkpoint_path, load_train_state, save_checkpoint, train_state
from .utils.device import compute_dtype_for, generator_seed, resolve_device, seeded_generator
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

    On a CUDA device, where a chunk of steps may be one CUDA graph, Adam
    runs ``capturable`` at every ``steps_per_dispatch``, with its step count
    and its rate in device tensors; a milestone schedule sets the rate on
    the device from that count: no step reads anything on the host, and a
    step has the same arithmetic inside a graph and out of one.

    With ``data_parallel``, :meth:`step` first sums the gradients (and the
    loss terms it is given) over the process group's ranks, so the norm,
    the clipping and the L2 term see the global batch's gradient.
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
        data_parallel: bool = False,
    ):
        self.params = list(params)
        self.data_parallel = data_parallel
        self.learning_rate = float(learning_rate)
        self.capturable = self.params[0].device.type == "cuda"
        lr = self.learning_rate
        if self.capturable:
            lr = torch.tensor(lr, dtype=torch.float32, device=self.params[0].device)
        self.hyper = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=float(weight_decay),
                          capturable=self.capturable)
        self.adam = torch.optim.Adam(self.params, **self.hyper)
        self.milestones = sorted(int(m) for m in lr_milestones or ())
        # on the parameters' device, where a captured step reads them
        self.milestone_tensor = torch.tensor(self.milestones, dtype=torch.float32,
                                             device=self.params[0].device)
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
        return self.learning_rate * self.lr_decay_factor**passed

    def rate_on_device(self, count: torch.Tensor) -> torch.Tensor:
        """:meth:`learning_rate_at` of a count held in a tensor, computed on
        its device in float64 and rounded to float32."""
        passed = (self.milestone_tensor.to(count.device) <= count).sum()
        rate = self.learning_rate * self.lr_decay_factor ** passed.to(torch.float64)
        return rate.to(torch.float32)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self, *totals: torch.Tensor):
        """Update the parameters from their gradients; return ``totals`` (a
        step's 0-dim loss terms), summed over the ranks when data-parallel."""
        if self.data_parallel:
            totals = dist.reduce_gradients(self.params, totals)
        if self.grad_clip_norm is not None:
            self.grad_norm = torch.nn.utils.clip_grad_norm_(self.params, self.grad_clip_norm)
        elif self.log_grad_norm:
            norms = [torch.linalg.vector_norm(p.grad) for p in self.params if p.grad is not None]
            self.grad_norm = torch.linalg.vector_norm(torch.stack(norms))
        if self.milestones and self.capturable:
            state = self.adam.state.get(self.params[0])
            count = state["step"] if state else torch.zeros((), device=self.params[0].device)
            self.hyper["lr"].copy_(self.rate_on_device(count))
        elif self.milestones:
            lr = self.learning_rate_at(self.count)
            for group in self.adam.param_groups:
                group["lr"] = lr
        if not self.capturable:
            self.adam.step()
            return totals
        with warnings.catch_warnings():
            # torch warns that a capturable Adam steps outside a graph: the
            # steps of steps_per_dispatch = 1 do, by design
            warnings.filterwarnings("ignore", message=".*capturable=True.*")
            self.adam.step()
        return totals

    def state_dict(self) -> Dict[str, Any]:
        state = self.adam.state_dict()
        for group in state["param_groups"]:
            group["lr"] = self.learning_rate
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore the moments and the step count; the hyper-parameters
        stay this run's, as the JAX package rebuilds its chain from the
        config and restores only the state arrays. The step count goes
        where this run's Adam keeps it (the parameter's device when
        capturable, else the host), so a checkpoint resumes across
        ``steps_per_dispatch``."""
        self.adam.load_state_dict(state)
        for group in self.adam.param_groups:
            group.update(self.hyper)
        for p in self.params:
            st = self.adam.state.get(p)
            if st:
                st["step"] = st["step"].to(device=p.device if self.capturable else "cpu",
                                           dtype=torch.float32)

    def load_jax_moments(self, moments: Dict[str, Any], names: List[str]) -> None:
        """Restore the JAX package's Adam state (:func:`adam_moments_from_jax`:
        ``count``, and ``exp_avg`` / ``exp_avg_sq`` by parameter name);
        ``names`` are the parameters' names in this optimizer's order."""
        state = self.adam.state_dict()
        state["state"] = {
            i: {"step": torch.tensor(float(moments["count"])),
                "exp_avg": moments["exp_avg"][name], "exp_avg_sq": moments["exp_avg_sq"][name]}
            for i, name in enumerate(names)
        }
        self.load_state_dict(state)


def make_optimizer(
    params,
    learning_rate: float,
    weight_decay: float = 0.01,
    lr_milestones=None,
    lr_decay_factor: float = 0.1,
    grad_clip_norm=None,
    log_grad_norm: bool = False,
    data_parallel: bool = False,
) -> TrainOptimizer:
    return TrainOptimizer(params, learning_rate, weight_decay, lr_milestones,
                          lr_decay_factor, grad_clip_norm, log_grad_norm, data_parallel)


def _prep_raw(raw, input_scale, compute_dtype):
    """Normalize on the device when ``transfer_precision="native"`` (crops
    ship in source units): one scalar multiply in the compute dtype, which
    in float32 gives the bits of the host's float32 normalization
    (``cellulus_tpu/train.py:_prep_raw``)."""
    if input_scale is None:
        return raw
    return raw.to(compute_dtype) * torch.tensor(input_scale, dtype=compute_dtype)


def make_train_step(model, optimizer, temperature: float, regularizer_weight: float,
                    compute_dtype=torch.float32, input_scale=None):
    """Step with host pairs in the repeated-anchor layout: ``step(raw (B,
    *spatial, C), anchors (B, P, D), references (B, P, D)) -> (loss, oce,
    offsets)``, all detached; the parameters are updated in place."""

    def step(raw, anchors, references):
        raw = _prep_raw(raw, input_scale, compute_dtype)
        optimizer.zero_grad()
        offsets = model(raw, compute_dtype)
        e_anchor = select_and_add_coordinates(offsets, anchors)
        e_reference = select_and_add_coordinates(offsets, references)
        loss, oce, _ = oce_loss(e_anchor, e_reference, temperature, regularizer_weight)
        loss.backward()
        loss, oce = optimizer.step(loss.detach(), oce.detach())
        return loss, oce, offsets.detach()

    return step


def make_train_step_fused(model, optimizer, temperature: float, regularizer_weight: float,
                          pair_sampler, batch_size: int, compute_dtype=torch.float32,
                          device="cpu", input_scale=None, rows: slice = slice(None)):
    """Step with pairs drawn on the device: ``step(raw, generator) -> (loss,
    oce, offsets)``. Each anchor embedding is gathered once and broadcast
    over its R references, which are gathered from the detached offsets
    (``train.py:186-206``): the same loss as the repeated-anchor layout.

    The pairs are drawn for the global batch of ``batch_size``; a
    data-parallel rank keeps its ``rows`` (a slice) of them, as every
    key-driven step does with its draws."""
    sample = pair_sampler.device_sampler_grouped(device)

    def step(raw, generator):
        raw = _prep_raw(raw, input_scale, compute_dtype)
        anchors, references = sample(generator, batch_size)
        anchors, references = anchors[rows], references[rows]
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
        loss, oce = optimizer.step(loss.detach(), oce.detach())
        return loss, oce, offsets.detach()

    return step


def _unbiased_region(pair_sampler):
    """``(k, unbiased shape, its area)``: anchors lie in ``[k, out - k)``."""
    k = int(pair_sampler.kappa)
    unbiased = tuple(s - 2 * k for s in pair_sampler.output_shape)
    return k, unbiased, float(np.prod(unbiased))


def grid_layout(pair_sampler):
    """``(stride, grid_dims, A, scale)`` of the grid loss
    (``cellulus_tpu/train.py:362-368``): a stride that gives about the
    sampler's anchor count over the unbiased region (Python's ``round``,
    half to even), the grid's extent per spatial axis, its anchor count,
    and the factor ``n_anchors / A`` that scales the loss to the reference's
    pair count."""
    _, unbiased, area = _unbiased_region(pair_sampler)
    ndim = len(unbiased)
    stride = max(1, int(round((area / max(pair_sampler.n_anchors, 1)) ** (1 / ndim))))
    grid_dims = tuple(max(1, u // stride) for u in unbiased)
    A = int(np.prod(grid_dims))
    return stride, grid_dims, A, pair_sampler.n_anchors / A


def grid_anchors(jitter: torch.Tensor, k: int, stride: int, grid_dims) -> torch.Tensor:
    """``(A, D)`` x-first anchor coordinates of the grid: spatial axis ``d``
    at ``k + jitter[d] + stride * i`` (``cellulus_tpu/train.py:373-383``)."""
    ndim = len(grid_dims)
    axis_coords = [k + jitter[d] + stride * torch.arange(g, device=jitter.device)
                   for d, g in enumerate(grid_dims)]
    mesh = torch.meshgrid(*axis_coords, indexing="ij")
    # component c indexes spatial axis ndim - 1 - c
    return torch.stack([mesh[ndim - 1 - c].reshape(-1) for c in range(ndim)], dim=-1)


def grid_anchor_offsets(offsets: torch.Tensor, jitter: torch.Tensor, k: int, stride: int,
                        grid_dims) -> torch.Tensor:
    """``(B, A, D)`` offsets at the grid's anchors, in :func:`grid_anchors`'
    order: a fixed block ``[k, k + stride * g)`` per spatial axis viewed as
    ``(g, stride)``, from which the jitter selects one phase. The jitter
    stays a device tensor, so the read asks the host for nothing."""
    batch, ndim = offsets.shape[0], len(grid_dims)
    block = offsets[(slice(None),) + tuple(slice(k, k + stride * g) for g in grid_dims)]
    block = block.reshape(batch, *[n for g in grid_dims for n in (g, stride)], offsets.shape[-1])
    for d in reversed(range(ndim)):
        block = block.index_select(2 + 2 * d, jitter[d : d + 1]).squeeze(2 + 2 * d)
    return block.reshape(batch, -1, offsets.shape[-1])


def make_train_step_grid(model, optimizer, temperature: float, regularizer_weight: float,
                         pair_sampler, batch_size: int, compute_dtype=torch.float32,
                         device="cpu", input_scale=None, rows: slice = slice(None)):
    """Stratified-anchor step (``cellulus_tpu/train.py:make_train_step_grid``):
    ``step(raw, generator, draws=None) -> (loss, oce, offsets)``.

    Anchors sit on a grid of ``stride`` over the unbiased region, shifted by
    one jitter per spatial axis shared by the batch; each anchor draws R iid
    reference offsets from the sampler's disk table, gathered from the
    detached offsets. The loss is the pair loss scaled by ``n_anchors / A``.
    ``draws = (jitter (D,) per spatial axis, idx (B, A, R))`` replaces the
    draws from ``generator`` (``draw(generator)``, the same order).

    The anchor embeddings are a strided read of the offsets field
    (:func:`grid_anchor_offsets`), not a gather. The draws are the global
    batch's; a data-parallel rank keeps its ``rows`` of ``idx``.
    """
    stride, grid_dims, A, scale = grid_layout(pair_sampler)
    k, _, _ = _unbiased_region(pair_sampler)
    ndim = len(grid_dims)
    R = pair_sampler.n_references
    table = torch.from_numpy(pair_sampler._offsets).long().to(device)

    def draw(generator):
        jitter = torch.randint(0, stride, (ndim,), generator=generator, device=device)
        idx = torch.randint(0, table.shape[0], (batch_size, A, R), generator=generator,
                            device=device)
        return jitter, idx

    def step(raw, generator, draws=None):
        jitter, idx = draw(generator) if draws is None else draws
        idx = idx[rows]
        b = idx.shape[0]
        raw = _prep_raw(raw, input_scale, compute_dtype)
        anchors = grid_anchors(jitter, k, stride, grid_dims)
        references = anchors[None, :, None, :] + table[idx]  # (b, A, R, D)

        optimizer.zero_grad()
        offsets = model(raw, compute_dtype)
        e_anchor = grid_anchor_offsets(offsets, jitter, k, stride, grid_dims)
        e_anchor = e_anchor + anchors.to(e_anchor.dtype)
        e_reference = select_and_add_coordinates(
            offsets.detach(), references.reshape(b, A * R, ndim)
        ).reshape(b, A, R, ndim)
        loss, oce, _ = oce_loss(
            e_anchor[:, :, None, :].expand(b, A, R, ndim), e_reference,
            temperature, regularizer_weight,
        )
        loss = loss * scale
        loss.backward()
        loss, oce = optimizer.step(loss.detach(), (oce * scale).detach())
        return loss, oce, offsets.detach()

    step.draw = draw
    return step


def make_train_step_dense(model, optimizer, temperature: float, regularizer_weight: float,
                          pair_sampler, batch_size: int, compute_dtype=torch.float32,
                          device="cpu", input_scale=None, rows: slice = slice(None)):
    """Gather-free step (``cellulus_tpu/train.py:make_train_step_dense``):
    ``step(raw, generator, draws=None) -> (loss, oce, field)``.

    For a reference offset ``o`` every pair ``(p, p + o)`` is a shift of the
    embedding field, so each of R offsets shared by the step is a slice of
    the detached field, and a Bernoulli mask of rate ``n_anchors / area``
    over the unbiased region picks the anchors. The regularizer is
    ``R * sum(mask * |e_anchor|)``, and loss and OCE term are scaled by
    ``batch_size * n_anchors / sum(mask)``. ``draws = (offsets (R, D)
    x-first, mask (B, *unbiased))`` replaces the draws from ``generator``
    (``draw(generator)``: the offset indices, then the mask).

    The R slices are one gather of the flattened field, its index built on
    the device from the offsets (the JAX package's ``lax.dynamic_slice``
    with traced starts): no step reads anything on the host, so a chunk of
    steps can be one CUDA graph. The mask is the global batch's: a
    data-parallel rank keeps its ``rows`` and scales by the global mask sum.

    EXPERIMENTAL, as in the JAX package: the shared offsets make per-step
    gradients about 10x noisier than the pair estimator, and training
    stalls.
    """
    k, unbiased, area = _unbiased_region(pair_sampler)
    out = pair_sampler.output_shape
    ndim = len(out)
    anchor_rate = min(1.0, pair_sampler.n_anchors / area)
    R = pair_sampler.n_references
    table = torch.from_numpy(pair_sampler._offsets).long().to(device)
    # absolute-coordinate grid, x-first channels, shaped (*out, D)
    axes = [torch.arange(n, dtype=torch.float32, device=device) for n in out]
    mesh = torch.meshgrid(*axes, indexing="ij")
    coord_grid = torch.stack([mesh[ndim - 1 - c] for c in range(ndim)], dim=-1)
    anchor_region = (slice(None),) + tuple(slice(k, k + u) for u in unbiased)
    # flat index in the (*out) field of each unbiased-region position, and
    # the flat step of one unit along each x-first offset component
    strides = [math.prod(out[d + 1 :]) for d in range(ndim)]
    region = torch.meshgrid(*[torch.arange(k, k + u, device=device) for u in unbiased],
                            indexing="ij")
    base = sum(r * st for r, st in zip(region, strides)).reshape(-1)
    offset_strides = torch.tensor([strides[ndim - 1 - c] for c in range(ndim)], device=device)

    def draw(generator):
        idx = torch.randint(0, table.shape[0], (R,), generator=generator, device=device)
        mask = torch.bernoulli(
            torch.full((batch_size, *unbiased), anchor_rate, device=device), generator=generator)
        return table[idx], mask

    def step(raw, generator, draws=None):
        offs, mask = draw(generator) if draws is None else draws
        raw = _prep_raw(raw, input_scale, compute_dtype)
        n_anchor_samples = torch.clamp(mask.sum(), min=1.0)
        mask = mask[rows]
        b = mask.shape[0]
        optimizer.zero_grad()
        field = model(raw, compute_dtype)
        e = field + coord_grid
        e_anchor = e[anchor_region]
        # (R, U) flat positions of the references: the anchors' shifted by o
        index = base[None, :] + (offs.to(base.device) * offset_strides).sum(dim=-1)[:, None]
        e_ref = e.detach().reshape(b, -1, ndim).index_select(1, index.reshape(-1))
        e_ref = e_ref.reshape(b, R, *unbiased, ndim)
        diff = e_anchor[:, None] - e_ref
        sq = (diff * diff).sum(dim=-1)
        oce = (mask[:, None] * (1.0 - torch.exp(-sq / temperature))).sum()
        reg = regularizer_weight * R * (mask * torch.linalg.vector_norm(e_anchor, dim=-1)).sum()
        scale = (batch_size * pair_sampler.n_anchors) / n_anchor_samples
        loss = (oce + reg) * scale
        loss.backward()
        loss, oce = optimizer.step(loss.detach(), (oce * scale).detach())
        return loss, oce, field.detach()

    step.draw = draw
    return step


class StepChunks:
    """The train steps of one chunk of ``steps_per_dispatch`` iterations, the
    port of ``make_multi_step`` (``cellulus_tpu/train.py:434-461``):
    ``run(it_start, batches) -> (losses (k,), oces (k,), grad_norm)``
    float32 device tensors, ``grad_norm`` the raw gradient norm of the
    chunk's last step when the optimizer logs it (else None). A graph's
    outputs are its static buffers: read them before the next ``run``.

    ``step`` takes ``(raw, generator)`` when ``key_driven`` (its draws come
    from the generator), else ``(raw, anchors, references)``; ``batches``
    are the loader's.

    On the CPU the k steps run one after another, each key-driven step with
    a generator seeded from (``seed`` + 17, iteration), as in the loop of
    one step. On a CUDA device they are one CUDA graph, captured at the
    first chunk of each length and replayed for the next ones: the inputs
    are copied into the graph's static ``(k, ...)`` buffers and step j
    draws from a generator of its own, registered with the graph and seeded
    before each replay from (``seed`` + 17, iteration), so a replay draws
    what the eager steps draw. Capture follows :data:`WARMUP` eager steps on
    a side stream (they build the kernels and Adam's state); the parameters
    and Adam's state are restored after them, so the first replay starts
    from the state the chunk was handed. The optimizer must be
    ``capturable`` (its parameters on the card). ``graphed=False`` runs the
    steps eagerly on any device (the yardstick a graph is held against).
    ``replays[k]`` counts each graph's replays.
    """

    WARMUP = 2

    def __init__(self, step, model, optimizer, device, key_driven: bool, seed: int,
                 graphed: Optional[bool] = None):
        self.step = step
        self.model = model
        self.optimizer = optimizer
        self.device = torch.device(device)
        self.key_driven = key_driven
        self.seed = seed
        self.graphed = self.device.type == "cuda" if graphed is None else graphed
        if self.graphed and not optimizer.capturable:
            raise ValueError("a graphed chunk needs a capturable optimizer")
        self.graphs: Dict[int, tuple] = {}
        self.replays: Dict[int, int] = {}
        self.generators: List[torch.Generator] = []

    def _one(self, inputs, iteration: int, generator=None):
        if not self.key_driven:
            return self.step(*inputs)
        if generator is None:
            generator = seeded_generator(self.device, self.seed + 17, iteration)
        return self.step(*inputs, generator)

    def _seed(self, it_start: int, k: int) -> None:
        for j, gen in enumerate(self.generators[:k]):
            gen.manual_seed(generator_seed(self.seed + 17, it_start + j))

    def host_inputs(self, batch):
        """A loader batch's step inputs as host tensors (raw channels-last)."""
        raw = torch.from_numpy(np.ascontiguousarray(np.moveaxis(batch[0], 1, -1)))
        if self.key_driven:
            return (raw,)
        return raw, torch.from_numpy(batch[1]), torch.from_numpy(batch[2])

    def run(self, it_start: int, batches):
        inputs = [self.host_inputs(b) for b in batches]
        if not self.graphed:
            losses, oces = [], []
            for j, step_inputs in enumerate(inputs):
                loss, oce, _ = self._one([t.to(self.device) for t in step_inputs], it_start + j)
                losses.append(loss.float())
                oces.append(oce.float())
            grad_norm = self.optimizer.grad_norm if self.optimizer.log_grad_norm else None
            return torch.stack(losses), torch.stack(oces), grad_norm
        k = len(inputs)
        if k not in self.graphs:
            self.graphs[k] = self._capture(it_start, inputs)
            self.replays[k] = 0
        graph, statics, outputs = self.graphs[k]
        for static, kind in zip(statics, zip(*inputs)):
            for j, t in enumerate(kind):
                static[j].copy_(t)
        self._seed(it_start, k)
        graph.replay()
        self.replays[k] += 1
        return outputs

    def _snapshot(self):
        params = [t.detach().clone() for t in self.model.state_dict().values()]
        adam = {p: {n: v.clone() for n, v in st.items()}
                for p, st in self.optimizer.adam.state.items()}
        return params, adam

    @torch.no_grad()
    def _restore(self, snapshot) -> None:
        params, adam = snapshot
        for t, saved in zip(self.model.state_dict().values(), params):
            t.copy_(saved)
        for p, st in self.optimizer.adam.state.items():
            for n, v in st.items():
                if p in adam:
                    v.copy_(adam[p][n])
                else:  # the warm-up made this state: Adam starts at zeros
                    v.zero_()

    def _capture(self, it_start: int, inputs):
        k = len(inputs)
        while len(self.generators) < k:
            self.generators.append(torch.Generator(device=self.device))
        statics = [torch.stack(kind).to(self.device) for kind in zip(*inputs)]
        snapshot = self._snapshot()
        self._seed(it_start, k)
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for j in range(min(self.WARMUP, k)):
                    self._one([s[j] for s in statics], it_start + j, self.generators[j])
            current.wait_stream(side)
            self._restore(snapshot)
            losses = torch.zeros(k, dtype=torch.float32, device=self.device)
            oces = torch.zeros(k, dtype=torch.float32, device=self.device)
            grad_norm = None
            if self.optimizer.log_grad_norm:
                grad_norm = torch.zeros((), dtype=torch.float32, device=self.device)
            graph = torch.cuda.CUDAGraph()
            for gen in self.generators[:k]:
                graph.register_generator_state(gen)
            # on `side`, a stream of this device (torch's default capture
            # stream belongs to whichever device was current at its first use)
            with torch.cuda.graph(graph, stream=side):
                for j in range(k):
                    loss, oce, _ = self._one([s[j] for s in statics], it_start + j,
                                             self.generators[j])
                    losses[j].copy_(loss)
                    oces[j].copy_(oce)
                if grad_norm is not None:
                    grad_norm.copy_(self.optimizer.grad_norm)
        return graph, statics, (losses, oces, grad_norm)


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


def _check_options(train_config, device, primary: bool = True) -> None:
    """Raise for the JAX package's two invalid combinations
    (``cellulus_tpu/train.py:683-705``) and for chunks that no CUDA graph can
    hold (a gloo group's reduce of CUDA tensors goes through the host); warn
    that dense loss does not learn."""
    if (train_config.steps_per_dispatch > 1 and dist.in_group()
            and torch.device(device).type == "cuda"
            and torch.distributed.get_backend() != "nccl"):
        raise ValueError(
            f"steps_per_dispatch={train_config.steps_per_dispatch} on CUDA needs the NCCL "
            f"backend: the {torch.distributed.get_backend()} group's all_reduce of CUDA "
            "tensors goes through the host and cannot be captured in a CUDA graph; use NCCL "
            "(one rank a GPU) or steps_per_dispatch = 1"
        )
    if train_config.loss_mode == "dense":
        warnings.warn(
            "loss_mode='dense' is EXPERIMENTAL and known NOT to learn "
            "(shared reference offsets make per-step gradients ~10x noisier; "
            "a 2000-iteration run failed to converge). Use loss_mode='grid' "
            "or 'pairs'.",
            stacklevel=3,
        )
        if primary:
            print("WARNING: loss_mode='dense' is experimental and does not reach "
                  "training quality; prefer 'grid' or 'pairs'.")
    native = train_config.transfer_precision == "native"
    if native and train_config.elastic_deform and not train_config.elastic_on_device:
        raise ValueError(
            "transfer_precision='native' requires host elastic off "
            "(deformation interpolates crops to float on the host); set "
            "elastic_on_device=true to combine them"
        )
    if (train_config.elastic_on_device and train_config.elastic_deform
            and not (train_config.device_pair_sampling
                     or train_config.loss_mode in ("grid", "dense"))):
        raise ValueError(
            "elastic_on_device needs a key-driven step: enable "
            "device_pair_sampling or use loss_mode 'grid'/'dense'"
        )


def data_parallel_ranks(train_config) -> int:
    """How many ranks :func:`train` starts outside a process group:
    ``data_parallelism``, or every visible GPU when it is None (one on the
    CPU), lowered to the largest divisor of ``batch_size``
    (``cellulus_tpu/train.py:799-815``). More GPUs than are visible raises
    ``ValueError``."""
    device = torch.device(train_config.device)
    n = train_config.data_parallelism
    if n is None:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    n = max(1, int(n))
    while train_config.batch_size % n:
        n -= 1
    if n > 1:
        local_devices(n, device)  # raises when fewer GPUs are visible
    return n


def train(experiment_config: ExperimentConfig,
          step_times: Optional[List[float]] = None) -> Dict[str, Any]:
    """Run training as configured; return the final state (the checkpoint's
    keys). ``step_times``, when given, receives the host clock at each
    iteration's loss fetch (each fetch waits for that step's device work).

    Data-parallel when this process is in a process group (formed by the
    caller, or by :func:`~cellulus_tpu_torch.parallel.distributed.initialize`
    from ``torchrun``'s environment: the rank then trains on
    ``cuda:{LOCAL_RANK}``); outside one with :func:`data_parallel_ranks` N >
    1, N ranks are spawned on ``localhost`` and rank 0's state returned."""
    train_config = experiment_config.train_config
    device = dist.initialize(train_config.device) or train_config.device
    if not dist.in_group():
        world = data_parallel_ranks(train_config)
        if world > 1:
            return dist.spawn(_train_rank, world, train_config.device, experiment_config)
    return _train(experiment_config, device, step_times)


def _train_rank(rank: int, experiment_config: ExperimentConfig) -> Dict[str, Any]:
    """One spawned rank of :func:`train`, on its own device (the process's
    current one)."""
    device = local_devices(dist.process_count(), experiment_config.train_config.device)[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return _train(experiment_config, device)


def _train(experiment_config: ExperimentConfig, device,
           step_times: Optional[List[float]] = None) -> Dict[str, Any]:
    train_config = experiment_config.train_config
    model_config = experiment_config.model_config
    rank = dist.process_index()
    primary = rank == 0
    data_parallel = dist.in_group()
    if primary:
        print(experiment_config)
    _check_options(train_config, device, primary)
    local_batch = dist.local_batch_size(train_config.batch_size)
    # this rank's rows of the global batch's draws
    rows = slice(rank * local_batch, (rank + 1) * local_batch)
    native_transfer = train_config.transfer_precision == "native"
    key_driven = train_config.device_pair_sampling or train_config.loss_mode != "pairs"
    elastic_device = train_config.elastic_on_device and train_config.elastic_deform
    device = resolve_device(device)
    say = print if primary else (lambda *args, **kwargs: None)
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
            # rank-disjoint crop streams: each rank samples its own share of
            # the global batch (cellulus_tpu/train.py:720)
            seed=train_config.seed + 10007 * rank,
            # host pairs feed only the host-sampled pair step
            sample_pairs=not key_driven,
            normalize=not native_transfer,
            pair_count_mode=train_config.pair_count_mode,
            elastic_device=train_config.elastic_on_device,
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
    model.remat = train_config.remat
    model.to(device)
    input_scale = dataset.normalization_factor if native_transfer else None
    optimizer = make_optimizer(
        model.parameters(),
        train_config.initial_learning_rate,
        lr_milestones=train_config.lr_milestones,
        lr_decay_factor=train_config.lr_decay_factor,
        grad_clip_norm=train_config.grad_clip_norm,
        log_grad_norm=train_config.log_grad_norm,
        data_parallel=data_parallel,
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
        say(f"Resuming model from {model_config.checkpoint}")
        state = load_train_state(model_config.checkpoint)
        load_state_dict(model, state["model_state_dict"])
        if state.get("optim_state_dict"):
            optimizer.load_state_dict(state["optim_state_dict"])
        elif state.get("jax_opt_leaves") is not None:
            # the JAX package's optax state (a .ckpt)
            moments = adam_moments_from_jax(
                state["jax_params"], state["jax_opt_leaves"], train_config.log_grad_norm,
                bool(train_config.lr_milestones))
            if moments is not None:
                optimizer.load_jax_moments(moments, [n for n, _ in model.named_parameters()])
        start_iteration = int(state.get("iteration", -1)) + 1
        lowest_loss = float(state.get("lowest_loss", 1e6))
        if state.get("logger_data"):
            logger.data = {k: list(state["logger_data"].get(k, [])) for k in logger.keys}

    if data_parallel:
        dist.broadcast_parameters(model)

    def to_device(raw_np):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(raw_np, 1, -1))).to(device)

    # validation: a fixed two-batch set, its loss logged at the best-model
    # cadence (the reference accepts validate_data_config but never uses it);
    # data-parallel, the primary validates on its own copy of the parameters
    val_batches = None
    if train_config.validate_data_config is not None and primary:
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

    # pallas_dw and packed_dw name JAX formulations of the filter gradient;
    # the port has one route for it (K2 in 2D, the library's in 3D)
    loss_args = (model, optimizer, train_config.temperature, train_config.regularizer_weight)
    if key_driven:
        make = {"grid": make_train_step_grid, "dense": make_train_step_dense}.get(
            train_config.loss_mode, make_train_step_fused)
        step = make(*loss_args, dataset.sampler, train_config.batch_size, compute_dtype,
                    device, input_scale=input_scale, rows=rows)
    else:
        step = make_train_step(*loss_args, compute_dtype, input_scale=input_scale)
    if elastic_device:
        # the warp runs in front of the key-driven step, drawing from its
        # generator: the loader ships padded crops
        deform = elastic_deform_batch(crop_size, train_config.control_point_spacing,
                                      train_config.control_point_jitter,
                                      batch_size=train_config.batch_size, rows=rows)
        inner_step = step

        def step(raw, generator):
            return inner_step(deform(raw, generator), generator)

    # each rank loads its share of the global batch
    loader = BatchLoader(dataset, local_batch, num_workers=train_config.num_workers)

    epoch_loss = 0.0
    num_iterations = 0
    iteration = start_iteration - 1
    pending = None  # (iteration, loss, oce[, grad_norm]) of the step in flight

    def consume(entry):
        nonlocal epoch_loss, num_iterations
        it, loss_t, oce_t = entry[:3]
        with torch.profiler.record_function("train: loss fetch"):
            loss_f, oce_f = float(loss_t), float(oce_t)
        if step_times is not None:
            step_times.append(time.perf_counter())
        if primary:
            # the loss is the global batch's on every rank; the primary
            # prints it and owns loss.csv
            print(f"===> iteration: {it}, loss: {loss_f:.6f}, oce loss: {oce_f:.6f}")
            logger.add("loss", loss_f)
            logger.add("oce_loss", oce_f)
            if len(entry) > 3:
                logger.add("grad_norm", float(entry[3]))
            logger.step()
        epoch_loss += loss_f
        num_iterations += 1

    def save(iteration: int, is_lowest: bool = False) -> None:
        if not primary:
            return
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
                say(f"Best model weights saved at iteration {iteration}")
            epoch_loss = 0.0
            num_iterations = 0
        if do_ckpt:
            save(iteration)
            say(f"Checkpoint saved at iteration {iteration}")
        if do_snapshot and offsets is not None and primary:
            # the primary's snapshot holds its own rows of the global batch
            meta = getattr(dataset, "meta", None)
            spatial_names = (
                [n for n in meta.axis_names if n not in ("s", "c")] if meta is not None else None
            )
            snap_raw = raw_np
            if input_scale is not None:
                snap_raw = raw_np.astype(np.float32) * input_scale
            save_snapshot(snap_raw, np.moveaxis(offsets.cpu().numpy(), -1, 1), iteration,
                          axis_names=spatial_names)

    # graceful stop: touching `stop_file` (relative to the working directory)
    # checkpoints the in-hand state and ends the loop. Only a file touched
    # after this moment counts; an older one is ignored, never deleted (the
    # 1 s margin absorbs coarse-mtime filesystems).
    stop_path = Path(train_config.stop_file) if train_config.stop_file else None
    stop_epoch = time.time() - 1.0
    if stop_path is not None and primary and stop_path.exists():
        warnings.warn(
            f"stop file {stop_path} predates this run and is ignored; "
            "touch it again to request a graceful stop"
        )
        stop_epoch = max(stop_epoch, stop_path.stat().st_mtime + 1e-3)

    def stop_file_touched() -> bool:
        try:
            return stop_path.stat().st_mtime >= stop_epoch
        except OSError:
            return False

    last_stop_check = start_iteration - 1

    def stop_requested(iteration: int) -> bool:
        nonlocal last_stop_check
        if stop_path is None:
            return False
        if not data_parallel:
            return stop_file_touched()
        # every rank must leave at the same step (a rank that stops alone
        # leaves the others waiting in the reduce): the primary's verdict,
        # broadcast at the best-model cadence (cellulus_tpu/train.py:1163-1180)
        if iteration - last_stop_check < max(1, train_config.save_best_model_every):
            return False
        last_stop_check = iteration
        return dist.broadcast_flag(primary and stop_file_touched(), device)

    def run_chunks(batches) -> int:
        """The loop in chunks of ``steps_per_dispatch`` steps
        (``cellulus_tpu/train.py:1253-1345``): the losses come back once a
        chunk and are logged a row an iteration; cadence actions and the
        stop file act at the chunk's end, saved under its last iteration
        (the parameters in hand), so a resume replays nothing. Returns
        the last iteration run."""
        chunks = StepChunks(step, model, optimizer, device, key_driven, train_config.seed)
        iteration = start_iteration - 1
        it = start_iteration
        while it < train_config.max_iterations:
            k_eff = min(K, train_config.max_iterations - it)
            chunk = [next(batches) for _ in range(k_eff)]
            losses, oces, grad_norm = chunks.run(it, chunk)
            losses, oces = losses.cpu().numpy(), oces.cpu().numpy()
            chunk_end = it + k_eff
            do_best = do_ckpt = do_snapshot = False
            for j in range(k_eff):
                iteration = it + j
                # only the chunk's last raw gradient norm is observable:
                # NaN rows keep the column aligned with the iterations
                gn = ()
                if train_config.log_grad_norm:
                    gn = (float(grad_norm) if j == k_eff - 1 else float("nan"),)
                consume((iteration, losses[j], oces[j]) + gn)
                do_best |= iteration % train_config.save_best_model_every == 0
                do_ckpt |= (iteration % train_config.save_model_every == 0
                            or iteration == train_config.max_iterations - 1)
                do_snapshot |= iteration % train_config.save_snapshot_every == 0
            raw_np = chunk[-1][0]
            if do_best or do_ckpt or do_snapshot:
                offsets = None
                if do_snapshot and primary:
                    with torch.no_grad():
                        offsets = model(_prep_raw(to_device(raw_np), input_scale, compute_dtype),
                                        compute_dtype)
                cadence_actions(iteration, offsets, raw_np, do_best, do_ckpt, do_snapshot)
            if stop_requested(iteration):
                cadence_actions(iteration, None, raw_np, do_best=False, do_ckpt=not do_ckpt,
                                do_snapshot=False)
                say(f"Stop file {stop_path} found: checkpointed at iteration "
                      f"{iteration}, exiting the training loop")
                break
            it = chunk_end
        return iteration

    K = train_config.steps_per_dispatch
    with loader:
        batches = iter(loader)
        if K > 1:
            iteration = run_chunks(batches)
        else:
            for iteration in range(start_iteration, train_config.max_iterations):
                # a named span for a profiler trace of the loop (cheap without one)
                with torch.profiler.record_function("train: next batch"):
                    batch = next(batches)
                raw_np = batch[0]
                raw = to_device(raw_np)
                if key_driven:
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
                    if (elastic_device and primary
                            and iteration % train_config.save_snapshot_every == 0):
                        # the step's offsets describe the warped crop: snapshot
                        # the padded crop with its own forward
                        with torch.no_grad():
                            offsets = model(_prep_raw(raw, input_scale, compute_dtype),
                                            compute_dtype)
                    cadence_actions(iteration, offsets, raw_np)
                if stop_requested(iteration):
                    if pending is not None:
                        consume(pending)
                        pending = None
                    cadence_actions(iteration, None, raw_np, do_best=False,
                                    do_ckpt=not is_ckpt, do_snapshot=False)
                    say(f"Stop file {stop_path} found: checkpointed at iteration "
                          f"{iteration}, exiting the training loop")
                    break

    if primary:
        logger.close()
    return train_state(iteration, lowest_loss, model, optimizer, logger.data)


# Callable module: keeps `cellulus_tpu_torch.train(config)` working after an
# `import cellulus_tpu_torch.train` rebinds the package attribute to this module.
class _CallableModule(type(sys.modules[__name__])):
    def __call__(self, experiment_config, step_times=None):
        return train(experiment_config, step_times)


sys.modules[__name__].__class__ = _CallableModule
