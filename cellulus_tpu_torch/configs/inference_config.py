"""Inference config (reference parity: ``cellulus/configs/inference_config.py:10-159``).

TPU extensions with reference-compatible defaults: ``tile_batch_size``,
``precision``, ``seed``, ``mean_shift_max_iterations``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .dataset_config import DatasetConfig
from .utils import as_config


@dataclass
class InferenceConfig:
    """Configuration of the 4-stage inference pipeline.

    Attributes:
        dataset_config: Raw data to predict on.
        prediction_dataset_config: Output of the predict stage (embeddings).
        detection_dataset_config: Output of the detect stage.
        segmentation_dataset_config: Output of the segment stage.
        evaluation_dataset_config: Ground-truth masks for evaluation.
        crop_size: Tile size used during sliding-window prediction.
        p_salt_pepper: Fraction of pixels receiving salt-and-pepper noise
            during test-time augmentation.
        num_infer_iterations: TTA passes per noise value (total passes is
            ``2 * num_infer_iterations``).
        threshold: Foreground/background threshold on the uncertainty channel;
            ``None`` = Otsu (or ``threshold_quantile`` when set).
        threshold_quantile: TPU extension — per-sample foreground threshold
            at this percentile (0-100) of the sample's uncertainty channel
            instead of Otsu. On dense tissue where foreground covers most of
            the image, Otsu's bimodal assumption breaks and cuts into real
            objects (measured on the recovered TissueNet panels: Otsu sits
            near the 60th percentile and misses up to 40% of GT-covered
            pixels; quantile 90 raised mean panel F1 0.255 -> 0.344).
            Mutually exclusive with ``threshold``.
        clustering: "meanshift" or "greedy".
        use_seeds: Seed mean-shift from minima of the smoothed offset field.
        bandwidth: Mean-shift bandwidth; ``None`` = ``0.5 * object_size``.
        num_bandwidths: Segmentations are produced for ``bandwidth / 2**k``.
        reduction_probability: Fraction of foreground pixels used to fit
            mean-shift; the rest is assigned by nearest-center prediction.
        min_size: Instances below this pixel count are dropped; ``None``
            derives it from ``object_size``.
        post_processing: "cell" (grow/shrink halo removal) or "nucleus"
            (per-instance intensity Otsu + hole filling).
        grow_distance / shrink_distance: Halo-removal radii ("cell" mode).
        device: Torch device the port runs on ("cuda:0" by default, "cpu"
            for the plain versions of the kernels); CUDA that is requested
            but missing is an error.
        tile_batch_size: Number of tiles predicted per device batch.
        mean_shift_max_iterations: Iteration cap of the on-device mean shift.
        transfer_precision: dtype for device->host embedding transfers
            ("float32" or "float16"); "float16" halves PCIe/host traffic at
            ~1e-3 relative precision cost (embeddings are stored as float32
            either way).
        vectorized_bandwidth_sweep: run all ``num_bandwidths`` mean-shift
            clusterings as one vmapped device computation (sharing one fit
            subsample) instead of serially.
        pipelined: overlap predict/detect/segment across samples
            (``pipeline.py``): predict in the calling thread, each sample's
            detect and segment in a stage worker on its own CUDA stream, the
            zarr writes in one I/O thread; the outputs equal the staged
            path's. Takes effect when the prediction, detection and
            segmentation configs are all present; otherwise the staged path
            runs.
        device_detect: run the detect stage's preparation on the device
            (Otsu or the quantile, the mask, the coordinate grid and the
            gather) before the mean-shift fit and predict. ``None`` defers
            to the ``CELLULUS_TPU_DEVICE_DETECT`` env var.
        spatial_shards: [tpu extension] predict each sample as ONE
            whole-volume forward sharded over this many devices along the
            first spatial axis, each shard's conv halo copied from its
            neighbours' devices (`parallel/spatial.py`; the workload's
            sequence-parallelism analogue). 0/1 = the default
            independent-tile path. Per-pixel outputs equal the tiled
            path's when `p_salt_pepper == 0` (with noise the TTA draws
            differ: tiles draw noise per tile batch, the sharded forward
            per sample and shard). On CUDA, fewer visible GPUs than shards
            raises ValueError; on the CPU the shards run in turn.
        device_nucleus: run "nucleus" post-processing on the device, all
            instances of a sample at once (``ops/nucleus.py``, the JAX
            package's device path: per-id histograms, a batched Otsu and
            hole filling by connected components of the dropped pixels),
            when it resolves to true: the field, or when ``None`` the
            ``CELLULUS_TPU_DEVICE_NUCLEUS`` env var. It differs from the
            host path only where one instance nests inside another's
            cavity. Either way the size filter runs on the device.
        pallas_mean_shift: in the JAX package, selects its Pallas
            ball-kernel fit. The port has one fit route, the hand kernel
            (``csrc/ball_stats.cu``) on the card, whatever this says.
        pipeline_ram_gb: host-RAM budget for pipelined inference's
            in-flight samples (each holds its float32 embeddings + a
            centered copy + detections); the stage workers are capped, with
            a ``RuntimeWarning``, so they fit it. ``None`` defers to the
            ``CELLULUS_TPU_PIPELINE_RAM_GB`` env var, then to a quarter of
            system RAM.
    """

    dataset_config: Optional[DatasetConfig] = None
    prediction_dataset_config: Optional[DatasetConfig] = None
    detection_dataset_config: Optional[DatasetConfig] = None
    segmentation_dataset_config: Optional[DatasetConfig] = None
    evaluation_dataset_config: Optional[DatasetConfig] = None
    device: str = "cuda:0"
    crop_size: List[int] = field(default_factory=lambda: [252, 252])
    p_salt_pepper: float = 0.01
    num_infer_iterations: int = 16
    threshold: Optional[float] = None
    threshold_quantile: Optional[float] = None
    clustering: str = "meanshift"
    use_seeds: bool = False
    bandwidth: Optional[float] = None
    num_bandwidths: int = 1
    reduction_probability: float = 0.1
    min_size: Optional[int] = None
    post_processing: str = "cell"
    grow_distance: int = 3
    shrink_distance: int = 6
    precision: str = "float32"
    seed: int = 0
    tile_batch_size: int = 4
    mean_shift_max_iterations: int = 300
    transfer_precision: str = "float32"
    vectorized_bandwidth_sweep: bool = False
    pipelined: bool = False
    device_detect: Optional[bool] = None
    device_nucleus: Optional[bool] = None
    pallas_mean_shift: Optional[bool] = None
    pipeline_ram_gb: Optional[float] = None
    spatial_shards: int = 0

    def __post_init__(self) -> None:
        for name in (
            "dataset_config",
            "prediction_dataset_config",
            "detection_dataset_config",
            "segmentation_dataset_config",
            "evaluation_dataset_config",
        ):
            setattr(self, name, as_config(DatasetConfig, getattr(self, name)))
        self.crop_size = list(self.crop_size)
        self.p_salt_pepper = float(self.p_salt_pepper)
        if self.clustering not in ("meanshift", "greedy"):
            raise ValueError("clustering must be 'meanshift' or 'greedy'")
        if self.post_processing not in ("cell", "nucleus"):
            raise ValueError("post_processing must be 'cell' or 'nucleus'")
        if self.threshold is not None:
            self.threshold = float(self.threshold)
        if self.threshold_quantile is not None:
            self.threshold_quantile = float(self.threshold_quantile)
            if not 0.0 < self.threshold_quantile < 100.0:
                raise ValueError("threshold_quantile must be in (0, 100)")
            if self.threshold is not None:
                raise ValueError(
                    "threshold and threshold_quantile are mutually exclusive"
                )
        if self.bandwidth is not None:
            self.bandwidth = float(self.bandwidth)
        if self.min_size is not None:
            self.min_size = int(self.min_size)
        if self.device_detect is not None:
            self.device_detect = bool(self.device_detect)
        if self.device_nucleus is not None:
            self.device_nucleus = bool(self.device_nucleus)
        if self.pallas_mean_shift is not None:
            self.pallas_mean_shift = bool(self.pallas_mean_shift)
        if self.pipeline_ram_gb is not None:
            self.pipeline_ram_gb = float(self.pipeline_ram_gb)
            if self.pipeline_ram_gb <= 0:
                raise ValueError("pipeline_ram_gb must be positive")
        self.spatial_shards = int(self.spatial_shards)
        if self.spatial_shards < 0:
            raise ValueError("spatial_shards must be >= 0")
