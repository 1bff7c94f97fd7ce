"""Device lists: the port's counterpart of the JAX package's device mesh.

``cellulus_tpu/parallel/mesh.py`` builds a 1-D ``data`` mesh over
``jax.devices()`` and lets XLA split a batch over it. The port runs in one
process over a list of ``torch.device`` s: a batch is split into one chunk
a device (:func:`shard_batch`), each device runs its chunk on its own copy
of the model (:func:`replicate`), and the chunks come back in order.

On the CPU a list of N devices is N times ``cpu``, and the chunks run in
turn: the counterpart of the JAX tests' forced host devices
(``tests/conftest.py:10-13``). On CUDA the default list is every visible
GPU (``CUDA_VISIBLE_DEVICES`` limits it), starting with the one asked for.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import torch


def local_devices(n: Optional[int] = None, device="cuda:0") -> List[torch.device]:
    """``n`` devices of ``device``'s type (every visible GPU when ``n`` is
    None; one CPU). A CUDA request for more devices than are visible raises
    ``ValueError`` (``cellulus_tpu/parallel/mesh.py:37-41``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * (1 if n is None else int(n))
    visible = torch.cuda.device_count()
    if n is None and visible == 0:
        return [device]  # CUDA is missing: its first use says so
    n = visible if n is None else int(n)
    if n > visible:
        raise ValueError(
            f"requested {n} data shards but only {visible} devices are available"
        )
    first = device.index or 0
    return [torch.device("cuda", (first + i) % visible) for i in range(n)]


def as_devices(devices) -> List[torch.device]:
    """``devices`` as ``torch.device`` s, a bare ``cuda`` as ``cuda:0``."""
    out = [torch.device(d) for d in devices]
    return [torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d for d in out]


def shard_batch(x: torch.Tensor, devices: Sequence, dim: int = 0):
    """``x`` in ``len(devices)`` contiguous chunks along ``dim``, as even as
    they come (``torch.tensor_split``: the first ``len % n`` one longer),
    each copied to its device: ``[(device, chunk)]`` in order, without the
    empty chunks of an ``x`` shorter than the list."""
    return [(d, chunk.to(d, non_blocking=True))
            for d, chunk in zip(devices, torch.tensor_split(x, len(devices), dim=dim))
            if chunk.shape[dim]]


def replicate(model: torch.nn.Module, devices: Sequence) -> Dict[torch.device, torch.nn.Module]:
    """One copy of ``model`` a distinct device of ``devices``: the model
    itself on its own device, a deep copy moved to each other one."""
    own = as_devices([next(model.parameters()).device])[0]
    replicas: Dict[torch.device, torch.nn.Module] = {}
    for d in as_devices(devices):
        if d not in replicas:
            replicas[d] = model if d == own else copy.deepcopy(model).to(d)
    return replicas
