"""The weight bridge: JAX params and reference-format ``.pth`` checkpoints.

- :func:`state_dict_from_jax_params` turns the JAX package's params pytree
  (``{"down": {"level<l>": {"conv<i>": {"w", "b"}}}, "up": ..., "head":
  ...}`` and, with ``constant_upsample=False``, ``"up_tconv"``, as numpy
  arrays, weights ``(*K, C_in, C_out)``) into the port's funlib-named
  state_dict (conv weights ``(C_out, C_in, *K)``, transposed-conv weights
  ``(C_in, C_out, *K)`` at ``backbone.r_up.0.<l>.up``), 2D or 3D.
- :func:`adam_moments_from_jax` maps the JAX package's optax Adam state
  (a ``.ckpt``'s ``opt_leaves``) onto the same names and layout, for a
  training run that resumes from a ``.ckpt``.
- :func:`load_state_dict` loads one into a model strictly, refusing a
  state_dict whose upsampling mode is not the model's, as the JAX package's
  ``forward`` does (``cellulus_tpu/models/unet.py:359-372``).
- :func:`load_checkpoint` reads a checkpoint into a model through
  :func:`load_state_dict`, by the file's content: a reference-format
  ``.pth`` (the dict the reference training loop saves, weights under
  ``model_state_dict``), or the JAX package's ``.ckpt`` (flax msgpack,
  read by ``utils/msgpack.py``; its ``params`` go through
  :func:`state_dict_from_jax_params`).
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils.checkpoint import checkpoint_format, read_jax_checkpoint


def _f32(leaf) -> np.ndarray:
    """A params leaf as float32 numpy (a bfloat16 leaf arrives as a tensor)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().cpu().numpy()
    return np.array(leaf, dtype=np.float32)


def _conv(conv_params: Dict[str, Any], prefix: str, out: dict, transposed=False) -> None:
    w = _f32(conv_params["w"])  # (*K, C_in, C_out)
    k = w.ndim - 2
    perm = ((k, k + 1) if transposed else (k + 1, k)) + tuple(range(k))
    out[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(w.transpose(perm)))
    out[f"{prefix}.bias"] = torch.from_numpy(_f32(conv_params["b"]))


def state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Funlib-named state_dict of a JAX params pytree."""
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
    for level in range(len(params.get("up_tconv", {}))):
        _conv(params["up_tconv"][f"level{level}"], f"backbone.r_up.0.{level}.up", sd,
              transposed=True)
    _conv(params["head"]["conv0"], "head.0", sd)
    _conv(params["head"]["conv1"], "head.2", sd)
    return sd


def _leaf_paths(tree, prefix=()) -> List[tuple]:
    """The paths of a nested dict's leaves in ``jax.tree_util.tree_leaves``
    order: keys sorted at every level."""
    if not isinstance(tree, dict):
        return [prefix]
    return [p for key in sorted(tree) for p in _leaf_paths(tree[key], prefix + (key,))]


def _unflatten(paths, leaves) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def adam_moments_from_jax(params: Dict[str, Any], opt_leaves, log_grad_norm: bool,
                          lr_milestones: bool) -> Optional[Dict[str, Any]]:
    """The JAX package's Adam state, from a ``.ckpt``'s ``opt_leaves``, for
    the port's ``torch.optim.Adam``: ``{"count", "exp_avg": state_dict,
    "exp_avg_sq": state_dict}``, the moments named and laid out as
    :func:`state_dict_from_jax_params` lays out the weights.

    ``opt_leaves`` is ``jax.tree_util.tree_leaves`` of the optax chain
    ``cellulus_tpu/train.py:make_optimizer`` builds: the recorded grad norm
    (with ``log_grad_norm``), ``scale_by_adam``'s ``count``, its ``mu`` and
    ``nu`` (each over ``params`` in sorted-key order), and the schedule's
    ``count`` (with ``lr_milestones``); clipping and the decay term hold
    none. msgpack may restore the list as a map keyed ``"0"``, ``"1"``, ...
    When the count does not match the configured optimizer, the JAX
    package's rule holds (``cellulus_tpu/train.py:unpack_opt_state``): a
    ``RuntimeWarning`` in its words, and None (fresh moments)."""
    if isinstance(opt_leaves, dict):
        opt_leaves = [opt_leaves[k] for k in sorted(opt_leaves, key=int)]
    paths = _leaf_paths(params)
    P = len(paths)
    first = 1 if log_grad_norm else 0
    expected = first + 1 + 2 * P + (1 if lr_milestones else 0)
    if len(opt_leaves) != expected:
        warnings.warn(
            f"checkpoint optimizer state has {len(opt_leaves)} arrays "
            f"but the configured optimizer expects {expected} "
            "(optimizer config changed since the checkpoint?); optimizer "
            "state reinitialized — Adam moments reset, lr_milestones count "
            "restarts at the resume iteration",
            RuntimeWarning,
            stacklevel=2,
        )
        return None
    mu = opt_leaves[first + 1 : first + 1 + P]
    nu = opt_leaves[first + 1 + P : first + 1 + 2 * P]
    return {
        "count": int(np.asarray(opt_leaves[first])),
        "exp_avg": state_dict_from_jax_params(_unflatten(paths, mu)),
        "exp_avg_sq": state_dict_from_jax_params(_unflatten(paths, nu)),
    }


def load_state_dict(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """``model.load_state_dict(state_dict, strict=True)``, after refusing a
    state_dict whose transposed-conv weights disagree with the model's
    ``constant_upsample``: such weights are never dropped or invented."""
    has_tconv = any(k.startswith("backbone.r_up.") for k in state_dict)
    if not model.constant_upsample and not has_tconv:
        raise ValueError(
            "model has constant_upsample=False but the weights carry no "
            "transposed-conv upsample weights (backbone.r_up.*): the checkpoint "
            "was trained with nearest-neighbor upsampling (set constant_upsample = true)"
        )
    if model.constant_upsample and has_tconv:
        raise ValueError(
            "the weights carry transposed-conv upsample weights (backbone.r_up.*) "
            "but the model has constant_upsample=True: running would silently ignore "
            "the checkpoint's upsample weights (set constant_upsample = false)"
        )
    model.load_state_dict(state_dict, strict=True)


def load_checkpoint(path, model: torch.nn.Module) -> Dict[str, Any]:
    """Load a checkpoint into ``model`` (strict, see :func:`load_state_dict`),
    a torch ``.pth`` or a JAX-package ``.ckpt`` by its content; return
    ``iteration``, ``lowest_loss``, ``logger_data`` and ``model_state_dict``
    (and a ``.pth``'s other keys). A corrupt or truncated ``.ckpt`` raises
    ``ValueError``."""
    path = Path(path)
    if checkpoint_format(path) == "jax":
        jax_state = read_jax_checkpoint(path)
        state = {
            "iteration": int(jax_state.get("iteration", -1)),
            "lowest_loss": float(jax_state.get("lowest_loss", float("inf"))),
            "logger_data": jax_state.get("logger_data", {}),
            "model_state_dict": state_dict_from_jax_params(jax_state["params"]),
        }
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    load_state_dict(model, state["model_state_dict"])
    return state
