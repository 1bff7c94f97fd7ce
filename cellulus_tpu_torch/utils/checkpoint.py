"""Train checkpoints as reference-format ``.pth`` files.

The keys are the reference's (reference ``train.py:126-149,183-191``):
``iteration``, ``lowest_loss``, ``model_state_dict``, ``optim_state_dict``
and ``logger_data``, written as ``models/best_loss.pth`` and
``models/NNNNNN.pth``. A file is written to a temporary name and moved into
place with ``os.replace``, so a reader never sees half a checkpoint
(``cellulus_tpu/utils/checkpoint.py:28-34``). ``infer`` loads
``model_state_dict`` strictly (:func:`cellulus_tpu_torch.models.load_checkpoint`).

Reading goes by a file's content, not its suffix (:func:`checkpoint_format`):
a zip or a pickle is a torch ``.pth``, a msgpack map is the JAX package's
``.ckpt`` (``utils/msgpack.py``), for inference and for a training run
to resume from. :func:`resolve_checkpoint` is the one rule
for a configured ``X.ckpt`` that does not exist while ``X.pth`` does.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from .msgpack import is_msgpack_map, unpackb

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


def checkpoint_format(path) -> str:
    """``"jax"`` for a flax msgpack checkpoint, ``"torch"`` for anything else
    (a ``torch.save`` zip or pickle; ``torch.load`` judges the rest)."""
    with open(path, "rb") as f:
        head = f.read(2)
    return "jax" if is_msgpack_map(head) else "torch"


def read_jax_checkpoint(path) -> Dict[str, Any]:
    """The JAX package's train state from a ``.ckpt``; ``ValueError`` with
    the JAX package's wording (``cellulus_tpu/utils/checkpoint.py:48-55``)
    when the file is corrupt or truncated."""
    path = Path(path)
    try:
        state = unpackb(path.read_bytes())
        if not isinstance(state, dict) or not isinstance(state.get("params"), dict):
            raise ValueError("no params map at the top level")
        return state
    except ValueError as e:
        raise ValueError(
            f"corrupt or truncated checkpoint {path} "
            f"({type(e).__name__}: {e}); if this was written by the "
            "reference implementation, name it with a .pth suffix"
        ) from e


def resolve_checkpoint(path, announce: bool = True) -> Optional[Path]:
    """The file to read for a configured checkpoint ``path``.

    The example TOMLs name the JAX package's ``models/best_loss.ckpt``; the
    port's ``train`` writes ``models/best_loss.pth``. So a configured
    ``X.ckpt`` that does not exist while ``X.pth`` beside it does is read as
    ``X.pth``, and (with ``announce``) one line naming both is printed.
    Every other path is returned as it is (``None`` stays ``None``)."""
    if path is None:
        return None
    path = Path(path)
    if path.suffix == ".ckpt" and not path.exists():
        pth = path.with_suffix(".pth")
        if pth.exists():
            if announce:
                print(f"checkpoint {path} does not exist: reading {pth}, the port's "
                      "checkpoint beside it")
            return pth
    return path


def load_train_state(path) -> Dict[str, Any]:
    """A train state for ``train()`` to resume from: a ``.pth`` as saved, or
    the JAX package's ``.ckpt`` with its weights as ``model_state_dict`` and,
    in place of ``optim_state_dict``, its params tree and optax leaves
    (``jax_params``, ``jax_opt_leaves``), which
    :func:`~cellulus_tpu_torch.models.adam_moments_from_jax` maps for the
    configured optimizer."""
    if checkpoint_format(path) != "jax":
        return torch.load(path, map_location="cpu", weights_only=True)
    from ..models.convert import state_dict_from_jax_params

    state = read_jax_checkpoint(path)
    return {
        "iteration": int(state.get("iteration", -1)),
        "lowest_loss": float(state.get("lowest_loss", 1e6)),
        "logger_data": {k: list(v) for k, v in state.get("logger_data", {}).items()},
        "model_state_dict": state_dict_from_jax_params(state["params"]),
        "jax_params": state["params"],
        "jax_opt_leaves": state.get("opt_leaves"),
    }
