"""Train config (reference parity: ``cellulus/configs/train_config.py:10-127``).

A copy of the JAX package's config: extra fields (``precision``, ``seed``,
``data_parallelism`` and those marked [tpu extension]) have defaults
chosen so reference TOML files work verbatim; each field's text says what
the port does with it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .dataset_config import DatasetConfig
from .utils import as_config


@dataclass
class TrainConfig:
    """Training hyper-parameters.

    Attributes:
        train_data_config: Dataset config for training data.
        train_data_configs: [tpu extension] Optional list of dataset configs
            for multi-dataset training; crops are drawn uniformly across
            datasets (all must share channel count and dimensionality).
        validate_data_config: Dataset config for validation data.
        crop_size: Spatial size of training crops (model input size).
        batch_size: Samples per optimization step (global batch across the
            device mesh).
        max_iterations: Number of optimization steps.
        initial_learning_rate: Adam learning rate.
        density: Fraction of pixels sampled as anchors per crop.
        kappa: Neighborhood radius for reference-pixel sampling.
        temperature: Gaussian damping factor of the OCE loss.
        regularizer_weight: Weight of the L2 regularizer on embeddings.
        save_model_every / save_best_model_every / save_snapshot_every:
            Checkpoint / best-tracking / snapshot cadences.
        num_workers: Host-side data-pipeline worker threads.
        elastic_deform: Enable elastic augmentation.
        control_point_spacing: Pixel spacing of elastic control points.
        control_point_jitter: Stddev of control-point jitter.
        device: Torch device training runs on ("cuda:0" by default, "cpu"
            for the plain versions of the kernels); CUDA that is requested
            but missing is an error.
        precision: "float32" or "bfloat16" compute for the model.
        seed: Base RNG seed for init + sampling.
        data_parallelism: Number of data-parallel ranks, one process a
            device (``parallel/distributed.py``); ``None`` = every visible
            GPU (one on the CPU), lowered to the largest divisor of
            ``batch_size``. Outside a process group ``train()`` spawns the
            ranks itself (NCCL on CUDA, gloo on the CPU); under ``torchrun``
            the group is the launcher's. On CUDA more ranks than visible
            GPUs raises ValueError.
        device_pair_sampling: Sample anchor/reference pairs on the device
            with a ``torch.Generator`` seeded by (seed + 17, iteration): the
            host sampler's distribution, no per-step coordinate transfer.
            Disable for the host sampler's stream (the JAX package's, draw
            for draw).
        loss_mode: "pairs" (reference-parity sampled pixel pairs; default),
            "grid" (anchors on a stride grid over the unbiased region with
            one jitter per spatial axis a step, R iid references each: the
            anchor gather becomes a strided read; the JAX package's 2D
            learning gate trains with it), or "dense" (EXPERIMENTAL
            shifted-field estimator: R offsets shared by a step and a
            Bernoulli anchor mask; the same expectation, but the shared
            offsets make gradients ~10x noisier and training stalls;
            ``train()`` warns). Grid and dense draw from the step's
            generator, as device pairs do.
        steps_per_dispatch: [tpu extension] Steps run as one chunk
            (``lax.scan`` in the JAX package). On a CUDA device the K steps
            of a chunk are one CUDA graph, captured once per chunk length
            and replayed, with Adam ``capturable`` and the milestone rate
            read on the device; on the CPU the chunk runs its steps
            eagerly. The losses come back once a chunk, cadence actions
            (best model, checkpoints, snapshots, the stop file) act at the
            chunk's end and save under its last iteration, and the last
            chunk may be shorter. Every loss mode runs so; data-parallel
            on CUDA the graph holds the gradients' all_reduce, which needs
            NCCL: in a gloo group values above 1 raise.
        transfer_precision: [tpu extension] "float32" ships normalized crops;
            "native" ships crops in the source dtype (uint8 crops are a
            quarter of the float32 bytes, uint16 half) and the step
            normalizes them on the device with one multiply in the compute
            dtype; in float32 the network sees the bits of the float32 path.
            Requires host elastic off (``elastic_deform=False`` or
            ``elastic_on_device=True``).
        elastic_on_device: [tpu extension] Run elastic augmentation on the
            device in front of the train step (``datasets/elastic_device.py``;
            the host path's parameter model, drawn from the step's
            generator, so results match the host warp in distribution, not
            bit for bit). The data workers only read padded crops; composes
            with transfer_precision="native". Requires a key-driven step
            (device_pair_sampling or loss_mode "grid"/"dense").
        lr_milestones: [paper recipe] Iterations at which the learning rate
            multiplies by ``lr_decay_factor``. The PAPER trains with
            LR / 10 at epochs 20 and 30 (Appendix A) but the reference CODE
            keeps Adam's LR constant — default None preserves code parity;
            set e.g. ``[62500, 93750]`` to reproduce the paper schedule at
            batch 8 on a 25k-sample epoch.
        lr_decay_factor: Multiplier applied at each milestone (paper: 0.1).
        grad_clip_norm: [tpu extension] Clip the gradient's global norm to
            this value before the optimizer update (torch
            ``clip_grad_norm_`` ordering: clip, then L2 decay + Adam). The
            OCE objective can diverge at aggressive learning rates (the
            embedding-magnitude regularizer explodes while the bounded OCE
            term saturates); default ``None`` never clips, matching the
            reference.
        log_grad_norm: [tpu extension] Record the raw (pre-clip) gradient
            global norm as a ``grad_norm`` column in ``loss.csv`` — the
            signal that catches OCE divergence immediately, and the
            measured basis for choosing ``grad_clip_norm``. Off by
            default: the recorder adds an optimizer-state leaf, so
            toggling it across a resume resets Adam moments (warned).
            With ``steps_per_dispatch`` > 1 only each chunk's last step
            is observable; other rows log NaN.
        remat: [tpu extension] Recompute each conv pass's activations in
            the backward (``torch.utils.checkpoint``, non-reentrant): peak
            activation memory drops to the passes' inputs at the cost of
            one more forward of the convs. Gradients identical (tested); in
            2D the recomputed backward's filter gradients still run on K2.
        pallas_dw: [tpu extension] In the JAX package, selects its Pallas
            filter-gradient kernel. In the port, ``pallas_dw`` and
            ``packed_dw`` both select the port's one filter-gradient route
            (kernel K2, ``csrc/conv_dw.cu``, in 2D; the library's in 3D),
            which every step takes anyway; at most one may be set.
        packed_dw: [tpu extension] In the JAX package, its packed-matmul
            formulation of the same filter gradient; in the port, the one
            route above (see ``pallas_dw``).
        stop_file: [tpu extension] Graceful-preemption sentinel: touching
            this file (path relative to the run's working directory, next
            to ``models/``) makes the loop checkpoint the in-hand state
            under its true iteration and return cleanly — the safe way to
            end a device-holding run without killing the process
            mid-dispatch. Only a file touched AFTER the run started
            counts: a pre-existing file with this name (or a stale
            sentinel from a previous stop) is ignored with a warning,
            never deleted. Under multi-process training the primary's
            verdict is broadcast at the ``save_best_model_every`` cadence
            so every process exits the same step. ``None`` disables the
            check.
        pair_count_mode: [tpu extension] "reference" replicates the
            reference's anchor-count formula, which uses only the first two
            spatial dims even in 3D (reference ``zarr_dataset.py:244-245``) —
            starving 3D crops of pairs; "all_dims" scales anchor count with
            the full unbiased volume and reference count with the kappa-ball
            volume.
    """

    train_data_config: Optional[DatasetConfig] = None
    train_data_configs: Optional[List[DatasetConfig]] = None
    validate_data_config: Optional[DatasetConfig] = None
    crop_size: List[int] = field(default_factory=lambda: [252, 252])
    batch_size: int = 8
    max_iterations: int = 100_000
    initial_learning_rate: float = 4e-5
    lr_milestones: Optional[List[int]] = None
    lr_decay_factor: float = 0.1
    grad_clip_norm: Optional[float] = None
    log_grad_norm: bool = False
    density: float = 0.1
    kappa: float = 10.0
    temperature: float = 10.0
    regularizer_weight: float = 1e-5
    save_model_every: int = 1_000
    save_best_model_every: int = 100
    save_snapshot_every: int = 1_000
    num_workers: int = 8
    elastic_deform: bool = True
    control_point_spacing: int = 64
    control_point_jitter: float = 2.0
    device: str = "cuda:0"
    precision: str = "float32"
    seed: int = 0
    data_parallelism: Optional[int] = None
    device_pair_sampling: bool = True
    loss_mode: str = "pairs"
    steps_per_dispatch: int = 1
    transfer_precision: str = "float32"
    pair_count_mode: str = "reference"
    elastic_on_device: bool = False
    packed_dw: bool = False
    pallas_dw: bool = False
    remat: bool = False
    stop_file: Optional[str] = "STOP"

    def __post_init__(self) -> None:
        self.train_data_config = as_config(DatasetConfig, self.train_data_config)
        if self.train_data_configs is not None:
            self.train_data_configs = [
                as_config(DatasetConfig, c) for c in self.train_data_configs
            ]
        self.validate_data_config = as_config(DatasetConfig, self.validate_data_config)
        self.crop_size = list(self.crop_size)
        self.initial_learning_rate = float(self.initial_learning_rate)
        self.density = float(self.density)
        self.kappa = float(self.kappa)
        self.temperature = float(self.temperature)
        self.regularizer_weight = float(self.regularizer_weight)
        self.lr_decay_factor = float(self.lr_decay_factor)
        if self.lr_milestones is not None:
            self.lr_milestones = [int(m) for m in self.lr_milestones]
        if self.grad_clip_norm is not None:
            self.grad_clip_norm = float(self.grad_clip_norm)
            if self.grad_clip_norm <= 0:
                raise ValueError("grad_clip_norm must be > 0")
        self.control_point_jitter = float(self.control_point_jitter)
        if self.precision not in ("float32", "bfloat16"):
            raise ValueError("precision must be 'float32' or 'bfloat16'")
        if self.loss_mode not in ("pairs", "grid", "dense"):
            raise ValueError("loss_mode must be 'pairs', 'grid' or 'dense'")
        self.steps_per_dispatch = int(self.steps_per_dispatch)
        if self.steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if self.transfer_precision not in ("float32", "native"):
            raise ValueError("transfer_precision must be 'float32' or 'native'")
        if self.pair_count_mode not in ("reference", "all_dims"):
            raise ValueError("pair_count_mode must be 'reference' or 'all_dims'")
        if self.pallas_dw and self.packed_dw:
            raise ValueError(
                "pallas_dw and packed_dw are mutually exclusive "
                "filter-gradient paths; enable at most one"
            )
