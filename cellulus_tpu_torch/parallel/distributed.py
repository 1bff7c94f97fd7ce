"""Data-parallel training over processes with ``torch.distributed``.

Port of ``cellulus_tpu/parallel/distributed.py``. Its contract
(``distributed.py:13-24``) holds here, one rank a device:

- every rank runs the same training loop with the same config;
- each rank loads ``batch_size / world`` crops (its local share) from the
  stream ``seed + 10007 * rank``, so a global batch holds distinct crops;
- parameters are broadcast from rank 0; after each backward one
  ``all_reduce(SUM)`` over a flat buffer of every gradient (and the step's
  loss terms) makes each rank's gradient the global batch's, which is a
  sum, as the JAX step's ``psum`` over the sharded batch: not a mean;
- checkpoints, snapshots and ``loss.csv`` are written by rank 0 only.

Outside a process group every helper is its single-process equivalent, so
the training loop calls them unconditionally.
"""

from __future__ import annotations

import os
import socket
import tempfile
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.env import env_flag

__all__ = [
    "broadcast_flag",
    "broadcast_parameters",
    "in_group",
    "initialize",
    "is_primary",
    "local_batch_size",
    "process_count",
    "process_index",
    "reduce_gradients",
    "spawn",
]


def in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(device="cuda:0") -> Optional[torch.device]:
    """Join a process group on an explicit request, and return this rank's
    device (``cuda:{LOCAL_RANK}`` for a CUDA ``device``, made the process's
    current device, else the CPU).

    A request is the environment ``torchrun`` sets (``WORLD_SIZE > 1`` with
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``), or
    ``CELLULUS_TPU_DISTRIBUTED=1`` with the same variables. The backend is
    NCCL for a CUDA ``device`` and gloo on the CPU. Without a request, or
    when this process is already in a group, nothing happens and None is
    returned."""
    if in_group():
        return None
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and not env_flag("CELLULUS_TPU_DISTRIBUTED"):
        return None
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    address = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device), init_method=address, world_size=world,
                            rank=rank)
    return device


def process_count() -> int:
    return dist.get_world_size() if in_group() else 1


def process_index() -> int:
    return dist.get_rank() if in_group() else 0


def is_primary() -> bool:
    """True on the rank that owns checkpoints, snapshots and logs."""
    return process_index() == 0


def local_batch_size(global_batch_size: int) -> int:
    """This rank's share of the global batch (must divide evenly)."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(
            f"batch_size {global_batch_size} is not divisible by the "
            f"process count {n}; choose a batch size that shards evenly "
            "across hosts"
        )
    return global_batch_size // n


def reduce_gradients(params: Sequence[torch.Tensor], totals: Sequence[torch.Tensor]):
    """Sum every parameter's gradient and the 0-dim ``totals`` (a step's loss
    terms) over the ranks, with one ``all_reduce`` of a flat float32 buffer;
    the gradients are replaced in place, the summed totals returned. Device
    work only, so a CUDA graph can hold it (NCCL)."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [t.reshape(1).float() for t in totals])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()
    return tuple(flat[offset + i].to(t.dtype) for i, t in enumerate(totals))


@torch.no_grad()
def broadcast_parameters(module: torch.nn.Module) -> None:
    """Every rank takes rank 0's parameters and buffers."""
    for t in module.state_dict().values():
        dist.broadcast(t, src=0)


def broadcast_flag(flag: bool, device) -> bool:
    """Rank 0's ``flag``, on every rank."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.broadcast(t, src=0)
    return bool(t.item())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, backend: str, fn, args, result_path) -> None:
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        out = fn(rank, *args)
        if rank == 0 and result_path is not None:
            torch.save(out, result_path)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, device, *args):
    """Run ``fn(rank, *args)`` in ``world`` new processes that form one group
    on ``localhost`` (NCCL for a CUDA ``device``, gloo on the CPU), wait for
    all of them, and return rank 0's result (through ``torch.save``)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.pt")
        mp.spawn(_worker, args=(world, free_port(), backend_for(device), fn, args, path),
                 nprocs=world, join=True)
        return torch.load(path, map_location="cpu", weights_only=False)
