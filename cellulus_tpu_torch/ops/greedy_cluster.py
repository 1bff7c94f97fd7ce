"""Greedy seed-and-grow clustering of embeddings, on the device.

Port of ``cellulus_tpu/ops/greedy_cluster.py`` (a ``lax.while_loop`` over
the full flattened arrays; plain JAX, no Pallas kernel). Each iteration, as
the JAX package's:

- pick the unclustered foreground pixel with the highest certainty score
  (the min-max-inverted uncertainty channel; ``argmax`` takes the first
  maximum), and stop when that score is below ``seed_thresh``,
- propose every foreground pixel with Gaussian affinity
  ``exp(-|e - e_seed|^2 / (2 bw^2)) > 0.5`` (the ``exp`` itself, since it
  rounds; not a rewritten distance test),
- accept the proposal as a new instance when ``prop_size >
  min_object_size`` and more than half of it is still unclustered
  (``still_free / max(prop_size, 1) > 0.5``), while the count stays within
  ``max_instances``,
- mark the proposal (and the seed) clustered either way.

The loop runs in fixed batches of iterations with the loop condition kept
on the device: once it fails, the remaining iterations of a batch change
nothing, which is the while loop bit for bit. The host reads a done flag
once a batch, not once an iteration. On CUDA one batch is captured as a
CUDA graph (after one warm-up iteration) and replayed; on the CPU the same
steps run eagerly. Captures take a process-wide lock and the
``"thread_local"`` capture mode, so greedy runs in the pipelined path's
worker threads while predict keeps launching in the calling thread.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from .mean_shift import add_coordinate_grid

# iterations per batch: the host reads the done flag once per batch
ITERATIONS_PER_BATCH = 64
_CAPTURE_LOCK = threading.Lock()


class _Loop:
    """The while loop's state and one iteration, in place on the device.

    Inputs, parameters and state live in tensors allocated once, so that a
    CUDA graph captured from :meth:`batch` replays on what :meth:`load`
    puts in them."""

    def __init__(self, P: int, D: int, device, max_instances: int):
        self.max_instances = int(max_instances)
        f32 = dict(dtype=torch.float32, device=device)
        self.emb = torch.empty((P, D), **f32)
        self.score = torch.empty((P,), **f32)
        self.fg = torch.empty((P,), dtype=torch.bool, device=device)
        self.inv_two_bw2 = torch.empty((), **f32)
        self.min_object_size = torch.empty((), **f32)
        self.seed_thresh = torch.empty((), **f32)
        self.min_unclustered_sum = torch.empty((), dtype=torch.int64, device=device)
        self.unclustered = torch.empty((P,), dtype=torch.bool, device=device)
        self.instance_map = torch.empty((P,), dtype=torch.int32, device=device)
        self.count = torch.empty((), dtype=torch.int32, device=device)
        self.stop = torch.empty((), dtype=torch.bool, device=device)
        self.iterations = torch.empty((), dtype=torch.int32, device=device)
        self.done = torch.empty((), dtype=torch.bool, device=device)
        # seed_of[i]: the pixel that seeded instance i (instance ids from 1)
        self.seed_of = torch.empty((self.max_instances + 2,), dtype=torch.int64, device=device)

    def load(self, emb, score, fg, bandwidth, min_object_size, seed_thresh,
             min_unclustered_sum):
        """Set the inputs and parameters, and the state to the loop's start."""
        self.emb.copy_(emb)
        self.score.copy_(score)
        self.fg.copy_(fg)
        bw = np.float32(bandwidth)
        self.inv_two_bw2.fill_(float(np.float32(1.0) / (np.float32(2.0) * bw * bw)))
        self.min_object_size.fill_(float(np.float32(min_object_size)))
        self.seed_thresh.fill_(float(seed_thresh))
        self.min_unclustered_sum.fill_(int(min_unclustered_sum))
        self.reset()

    def reset(self):
        """The state at the loop's start."""
        self.unclustered.fill_(True)
        self.instance_map.zero_()
        self.count.fill_(1)
        self.stop.fill_(False)
        self.iterations.zero_()
        self.done.fill_(False)
        self.seed_of.zero_()

    def step(self):
        free = self.unclustered & self.fg
        live = (~self.stop) & (free.sum() > self.min_unclustered_sum) & (
            self.count <= self.max_instances)
        masked = self.score * free.float()
        seed = torch.argmax(masked).view(1)
        seed_ok = masked.index_select(0, seed)[0] >= self.seed_thresh
        diff = self.emb - self.emb.index_select(0, seed)
        sq = diff[:, 0] * diff[:, 0]
        for k in range(1, diff.shape[1]):
            sq = sq + diff[:, k] * diff[:, k]
        affinity = torch.exp(-sq * self.inv_two_bw2)
        proposal = (affinity > 0.5) & self.fg
        prop_size = proposal.sum()
        still_free = (proposal & self.unclustered).sum()
        accept = live & seed_ok & (prop_size.float() > self.min_object_size) & (
            still_free.float() / torch.clamp(prop_size, min=1).float() > 0.5)
        self.instance_map.copy_(torch.where(accept & proposal, self.count, self.instance_map))
        slot = torch.clamp(self.count, max=self.max_instances + 1).long().view(1)
        self.seed_of.index_copy_(0, slot, torch.where(accept, seed, self.seed_of.index_select(0, slot)))
        self.count.add_(accept.int())
        marked = self.unclustered & ~(proposal & seed_ok)
        marked.index_fill_(0, seed, False)
        self.unclustered.copy_(torch.where(live, marked, self.unclustered))
        self.stop.copy_(torch.where(live, ~seed_ok, self.stop))
        self.iterations.add_(live.int())
        self.done.copy_(~live)

    def batch(self, n):
        for _ in range(n):
            self.step()


def greedy_cluster(
    prediction: np.ndarray,
    fg_mask: np.ndarray,
    bandwidth: float,
    min_object_size: float,
    seed_thresh: float = 0.9,
    min_unclustered_sum: int = 0,
    max_instances: int = 8192,
    device="cuda:0",
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Cluster one sample's prediction into instances.

    Args:
        prediction: ``(D+1, *spatial)``: offset channels (x-first) followed
            by the uncertainty channel.
        fg_mask: ``(*spatial,)`` boolean foreground.
        stats: when given, receives ``iterations`` (of the while loop),
            ``host_syncs`` (reads of the done flag), ``instances`` and
            ``seeds`` (the flat pixel index that seeded each instance).

    Returns:
        ``(*spatial,)`` int32 instance map (background 0).
    """
    prediction = np.asarray(prediction, dtype=np.float32)
    ndim = prediction.ndim - 1
    uncertainty = prediction[ndim]
    absolute = add_coordinate_grid(prediction[:ndim])
    # min-max inverted score: low uncertainty -> score near 1
    lo, hi = uncertainty.min(), uncertainty.max()
    denom = lo - hi if lo != hi else 1.0
    score = (uncertainty - hi) / denom

    dev = torch.device(device)
    P = int(np.prod(uncertainty.shape))
    inputs = (torch.from_numpy(np.ascontiguousarray(absolute.reshape(ndim, P).T)),
              torch.from_numpy(np.ascontiguousarray(score.ravel(), dtype=np.float32)),
              torch.from_numpy(np.ascontiguousarray(fg_mask.ravel().astype(bool))),
              bandwidth, min_object_size, seed_thresh, min_unclustered_sum)
    n = ITERATIONS_PER_BATCH
    syncs = 0
    loop = _Loop(P, ndim, dev, max_instances)
    loop.load(*inputs)
    run = lambda: loop.batch(n)  # noqa: E731
    if dev.type == "cuda":
        # one warm-up iteration, then the capture (which runs nothing), then
        # the loop from its start again
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            loop.step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # one capture at a time in the process (the pipelined path runs
        # detect in worker threads); "thread_local" lets the other threads
        # (predict's tile batches) allocate and sync while this one captures
        with _CAPTURE_LOCK, torch.cuda.graph(graph, capture_error_mode="thread_local"):
            loop.batch(n)
        loop.reset()
        run = graph.replay
    while True:
        run()
        syncs += 1
        if bool(loop.done):
            break
    if stats is not None:
        instances = int(loop.count) - 1
        stats.update(iterations=int(loop.iterations), host_syncs=syncs, instances=instances,
                     seeds=loop.seed_of[1:instances + 1].cpu().numpy())
    return loop.instance_map.cpu().numpy().reshape(uncertainty.shape)
