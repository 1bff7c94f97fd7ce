"""Dataset location config (reference parity: ``cellulus/configs/dataset_config.py:7-41``)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional


@dataclass
class DatasetConfig:
    """Points at a zarr container and the dataset(s) inside it.

    Attributes:
        container_path: Path to the zarr/N5 container.
        dataset_name: Name of the dataset inside the container. For pipeline
            stages this is the *output* dataset of the stage.
        secondary_dataset_name: Name of the dataset holding the *input* to a
            stage (e.g. during segmentation, ``dataset_name`` is the output
            masks and ``secondary_dataset_name`` the input detections).
    """

    container_path: Path
    dataset_name: str
    secondary_dataset_name: Optional[str] = None

    def __post_init__(self) -> None:
        self.container_path = Path(self.container_path)
        if not isinstance(self.dataset_name, str):
            raise TypeError("dataset_name must be a string")
        if self.secondary_dataset_name is not None and not isinstance(
            self.secondary_dataset_name, str
        ):
            raise TypeError("secondary_dataset_name must be a string or None")
