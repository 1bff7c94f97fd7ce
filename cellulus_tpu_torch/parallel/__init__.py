"""Multi-GPU execution: data-parallel training over processes
(:mod:`.distributed`), device lists for predict's tile batch and the
stages' round-robin (:mod:`.mesh`), and the spatially sharded forward
(:mod:`.spatial`). Port of ``cellulus_tpu/parallel/``."""

from . import distributed
from .mesh import as_devices, local_devices, replicate, shard_batch

__all__ = ["as_devices", "distributed", "local_devices", "replicate", "shard_batch"]
