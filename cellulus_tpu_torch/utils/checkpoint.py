"""Train checkpoints as reference-format ``.pth`` files.

The keys are the reference's (reference ``train.py:126-149,183-191``):
``iteration``, ``lowest_loss``, ``model_state_dict``, ``optim_state_dict``
and ``logger_data``, written as ``models/best_loss.pth`` and
``models/NNNNNN.pth``. A file is written to a temporary name and moved into
place with ``os.replace``, so a reader never sees half a checkpoint
(``cellulus_tpu/utils/checkpoint.py:28-34``). ``infer`` loads
``model_state_dict`` strictly (:func:`cellulus_tpu_torch.models.load_checkpoint`).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict

import torch


def save_checkpoint(path, state: Dict[str, Any]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def checkpoint_path(iteration: int, is_lowest: bool = False) -> Path:
    """Reference naming (``train.py:183-191``)."""
    return Path("models") / ("best_loss.pth" if is_lowest else str(iteration).zfill(6) + ".pth")


def train_state(iteration: int, lowest_loss: float, model, optimizer, logger_data) -> Dict[str, Any]:
    return {
        "iteration": int(iteration),
        "lowest_loss": float(lowest_loss),
        "model_state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optim_state_dict": optimizer.state_dict(),
        "logger_data": {k: list(v) for k, v in logger_data.items()},
    }


def load_train_state(path) -> Dict[str, Any]:
    path = Path(path)
    if path.suffix != ".pth":
        raise ValueError(
            f"{path} is not a .pth checkpoint; convert a JAX-package .ckpt with "
            "cellulus_tpu.models.torch_export.save_torch_checkpoint"
        )
    return torch.load(path, map_location="cpu", weights_only=True)
