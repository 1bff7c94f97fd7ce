"""One rank of ``tests/test_torch_data_parallel.py``'s steps: it imports
torch and the port only, so a spawned rank starts in a few seconds.

A case is a dict: ``mode`` ("pairs", "grid" or "dense"), the U-Net's
arguments and weights, the optimizer's arguments, the global batch (``raw``
and, for pairs, ``anchors`` / ``references``) and, for grid and dense, the
global batch's ``draws``. :func:`run_case` runs one step of it on the rows a
rank owns; :func:`rank_main` runs every case on this rank's half.
"""

import numpy as np
import torch

from cellulus_tpu_torch.datasets import PairSampler
from cellulus_tpu_torch.models import UNet
from cellulus_tpu_torch.parallel import distributed as dist
from cellulus_tpu_torch.train import (
    make_optimizer,
    make_train_step,
    make_train_step_dense,
    make_train_step_grid,
)

TEMPERATURE, REG = 10.0, 1e-5


def run_case(case, data_parallel: bool, rows: slice):
    """One step of ``case`` on the batch rows ``rows``: ``(loss, oce,
    parameters, grad_norm)``."""
    model = UNet(**case["model"])
    model.load_state_dict(case["state_dict"])
    optimizer = make_optimizer(model.parameters(), case["lr"], log_grad_norm=True,
                               data_parallel=data_parallel, **case["optimizer"])
    raw = torch.from_numpy(case["raw"][rows])
    if case["mode"] == "pairs":
        step = make_train_step(model, optimizer, TEMPERATURE, REG)
        loss, oce, _ = step(raw, torch.from_numpy(case["anchors"][rows]),
                            torch.from_numpy(case["references"][rows]))
    else:
        make = {"grid": make_train_step_grid, "dense": make_train_step_dense}[case["mode"]]
        sampler = PairSampler(case["out"], density=case["density"], kappa=case["kappa"])
        step = make(model, optimizer, TEMPERATURE, REG, sampler, len(case["raw"]),
                    torch.float32, "cpu", rows=rows)
        loss, oce, _ = step(raw, None, draws=case["draws"])
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return float(loss), float(oce), params, float(optimizer.grad_norm)


def rank_main(rank: int, cases):
    """Every case on this rank's half of its global batch; returns, by
    case, the loss, the OCE term, the parameters, the gradient norm and the
    largest difference between any rank's parameters and rank 0's."""
    torch.set_num_threads(1)
    world = dist.process_count()
    out = {}
    for name, case in cases.items():
        b = len(case["raw"]) // world
        loss, oce, params, grad_norm = run_case(case, True, slice(rank * b, (rank + 1) * b))
        flat = torch.cat([p.reshape(-1) for p in params.values()])
        ref = flat.clone()
        torch.distributed.broadcast(ref, src=0)
        spread = (flat - ref).abs().max().reshape(1)
        torch.distributed.all_reduce(spread, op=torch.distributed.ReduceOp.MAX)
        out[name] = dict(loss=loss, oce=oce, params=params, grad_norm=grad_norm,
                         spread=float(spread))
    return out


def crops_of(loader_cls, rank: int):
    """A ``BatchLoader`` subclass that saves its first batch's crops as
    ``crops_rank{rank}.npy`` in the working directory."""

    class Recording(loader_cls):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == 0:
                    np.save(f"crops_rank{rank}.npy", batch[0])
                yield batch

    return Recording
