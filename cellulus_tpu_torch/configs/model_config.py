"""Model config (reference parity: ``cellulus/configs/model_config.py:10-59``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

from .utils import as_path


@dataclass
class ModelConfig:
    """Configuration of the OCE U-Net.

    Attributes:
        num_fmaps: Feature maps in the first U-Net level.
        fmap_inc_factor: Channel growth factor per level.
        features_in_last_layer: Channels of the final U-Net layer / head input.
        downsampling_factors: One entry per downsampling step, each a
            per-dimension factor, e.g. ``[[2, 2]]``.
        checkpoint: Optional checkpoint path (resume training / inference).
            Both cellulus-tpu ``.ckpt`` and reference PyTorch ``.pth``
            checkpoints are accepted (see ``cellulus_tpu.models.torch_import``).
        initialize: If True, (re-)initialize conv weights with Kaiming-normal
            (reference ``train.py:65-68``).
        constant_upsample: [tpu extension] If True (default, and the
            reference's hardcoded choice — reference ``models/unet.py:50``),
            the up path uses nearest-neighbor upsampling. If False, it uses
            a learned transposed conv with kernel = stride = the level's
            downsampling factor (the funlib backbone's other mode), so
            funlib checkpoints trained with ``constant_upsample=False``
            import and run.
    """

    num_fmaps: int
    fmap_inc_factor: int
    features_in_last_layer: int = 64
    downsampling_factors: List[List[int]] = field(default_factory=lambda: [[2, 2]])
    checkpoint: Optional[Path] = None
    initialize: bool = True
    constant_upsample: bool = True

    def __post_init__(self) -> None:
        if not isinstance(self.num_fmaps, int):
            raise TypeError("num_fmaps must be an int")
        if not isinstance(self.fmap_inc_factor, int):
            raise TypeError("fmap_inc_factor must be an int")
        self.checkpoint = as_path(self.checkpoint)
        self.downsampling_factors = [list(f) for f in self.downsampling_factors]
