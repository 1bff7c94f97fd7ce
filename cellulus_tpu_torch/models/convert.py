"""The weight bridge: JAX params and reference-format ``.pth`` checkpoints.

- :func:`state_dict_from_jax_params` turns the JAX package's params pytree
  (``{"down": {"level<l>": {"conv<i>": {"w", "b"}}}, "up": ..., "head":
  ...}``, as numpy arrays, weights ``(*K, C_in, C_out)``) into the port's
  funlib-named state_dict (weights ``(C_out, C_in, *K)``).
- :func:`load_checkpoint` reads a reference-format ``.pth`` (the dict the
  reference training loop saves, weights under ``model_state_dict``) into a
  model with ``load_state_dict(strict=True)``.

The JAX package's own ``.ckpt`` files are flax msgpack and are not read
here: convert them once with the JAX package's
``cellulus_tpu.models.torch_export.save_torch_checkpoint``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch


def _conv(conv_params: Dict[str, Any], prefix: str, out: dict) -> None:
    w = np.asarray(conv_params["w"], dtype=np.float32)  # (*K, C_in, C_out)
    k = w.ndim - 2
    perm = (k + 1, k) + tuple(range(k))
    out[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(w.transpose(perm)))
    out[f"{prefix}.bias"] = torch.from_numpy(np.array(conv_params["b"], dtype=np.float32))


def state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Funlib-named state_dict of a JAX params pytree."""
    if "up_tconv" in params:
        raise NotImplementedError(
            "transposed-conv upsampling weights are not ported yet "
            "(ROADMAP: port queue, constant_upsample=False)"
        )
    down, up = params["down"], params["up"]
    if len(up) != len(down) - 1:
        raise ValueError(
            f"params tree has {len(down)} down levels but {len(up)} up levels"
        )
    sd: Dict[str, torch.Tensor] = {}
    for level in range(len(down)):
        for i in range(len(down[f"level{level}"])):
            _conv(down[f"level{level}"][f"conv{i}"],
                  f"backbone.l_conv.{level}.conv_pass.{2 * i}", sd)
    for level in range(len(up)):
        for i in range(len(up[f"level{level}"])):
            _conv(up[f"level{level}"][f"conv{i}"],
                  f"backbone.r_conv.0.{level}.conv_pass.{2 * i}", sd)
    _conv(params["head"]["conv0"], "head.0", sd)
    _conv(params["head"]["conv1"], "head.2", sd)
    return sd


def load_checkpoint(path, model: torch.nn.Module) -> Dict[str, Any]:
    """Load a reference-format ``.pth`` into ``model`` (strict); return the
    checkpoint dict (``iteration``, ``lowest_loss``, ...)."""
    path = Path(path)
    if path.suffix == ".ckpt":
        raise ValueError(
            f"{path} is a JAX-package checkpoint (flax msgpack); convert it "
            "to .pth with cellulus_tpu.models.torch_export.save_torch_checkpoint"
        )
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model_state_dict"], strict=True)
    return state
