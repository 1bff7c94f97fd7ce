"""Top-level experiment config (reference parity: ``cellulus/configs/experiment_config.py:12-62``)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from datetime import datetime
from typing import Optional

from .inference_config import InferenceConfig
from .model_config import ModelConfig
from .train_config import TrainConfig
from .utils import as_config, asdict_config


@dataclass
class ExperimentConfig:
    """Everything needed to run training and inference.

    Attributes:
        model_config: Model architecture config (required).
        experiment_name: Unique experiment name (defaults to today's date).
        normalization_factor: Raw-intensity scale factor; ``None`` derives it
            from the array dtype (uint8 -> 1/255, ...).
        object_size: Rough object diameter in pixels; drives the default
            mean-shift bandwidth and minimum instance size.
        train_config: Training config.
        inference_config: Inference config.
    """

    model_config: ModelConfig
    experiment_name: str = field(
        default_factory=lambda: datetime.today().strftime("%Y-%m-%d")
    )
    normalization_factor: Optional[float] = None
    object_size: float = 30
    train_config: Optional[TrainConfig] = None
    inference_config: Optional[InferenceConfig] = None

    def __post_init__(self) -> None:
        self.model_config = as_config(ModelConfig, self.model_config)
        if self.model_config is None:
            raise ValueError("model_config is required")
        self.train_config = as_config(TrainConfig, self.train_config)
        self.inference_config = as_config(InferenceConfig, self.inference_config)
        if self.normalization_factor is not None:
            self.normalization_factor = float(self.normalization_factor)

    @classmethod
    def from_toml(cls, path) -> "ExperimentConfig":
        import tomllib

        with open(path, "rb") as f:
            return cls(**tomllib.load(f))

    def __str__(self) -> str:
        return json.dumps(asdict_config(self), indent=2, default=str)
