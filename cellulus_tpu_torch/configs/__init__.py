"""Typed configuration objects for cellulus-tpu.

A copy of the JAX package's ``configs`` (framework-free): the PyTorch port
parses the same TOML files and imports nothing of the JAX package.

TOML files written for the reference implementation (funkelab/cellulus,
``cellulus/configs/``) load unchanged: field names, nesting and defaults
mirror the reference's attrs classes (reference ``configs/experiment_config.py:12-62``,
``configs/train_config.py:10-127``, ``configs/inference_config.py:10-159``,
``configs/model_config.py:10-59``, ``configs/dataset_config.py:7-41``).
"""

from .dataset_config import DatasetConfig
from .experiment_config import ExperimentConfig
from .inference_config import InferenceConfig
from .model_config import ModelConfig
from .train_config import TrainConfig

__all__ = [
    "DatasetConfig",
    "ExperimentConfig",
    "InferenceConfig",
    "ModelConfig",
    "TrainConfig",
]
