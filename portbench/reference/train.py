"""Training steps in plain PyTorch: U-Net, OCE loss on sampled pixel pairs,
Adam.

The reference's step (``cellulus/train.py``, ``criterions/oce_loss.py``):
the U-Net's offsets plus each pixel's coordinate are the embeddings; for
each anchor pixel and each of its references within the kappa disk, the
loss adds ``1 - exp(-|e_a - sg(e_r)|^2 / temperature)`` and
``regularizer_weight * |e_a|`` (a sum, not a mean); Adam with the L2 decay
added to the gradient before the moments (torch's Adam with
``weight_decay``), written out here.

The pairs are drawn on the device as the port draws them (a frozen copy
of its ``PairSampler.device_sampler_grouped``): per step one generator
seeded by a SeedSequence hash of ``(seed, 17, step)``; anchors uniform in
``[kappa, output - kappa]`` per x-first component, ``density * unbiased[0]
* unbiased[1]`` of them a crop, each with ``density * kappa^2 * pi``
references at offsets drawn uniformly from the non-zero lattice points
strictly inside the kappa disk.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .infer import generator_seed
from .unet import forward


class Pairs:
    """The pair draw of one configuration (output size, density, kappa)."""

    def __init__(self, output_shape, density: float, kappa: float, device):
        ndim = len(output_shape)
        unbiased = [int(s - 2 * kappa) for s in output_shape]
        self.n_anchors = int(density * unbiased[0] * unbiased[1])
        self.n_refs = int(density * kappa**2 * math.pi)
        r = int(math.ceil(kappa))
        axes = [np.arange(-r, r + 1)] * ndim
        grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, ndim)
        sq = (grid**2).sum(axis=1)
        self.offsets = torch.from_numpy(
            grid[(sq < kappa**2) & (sq > 0)].astype(np.int64)).to(device)
        k = int(kappa)
        self.lows = [k] * ndim
        self.highs = [int(s) - k + 1 for s in reversed(output_shape)]
        self.device = device

    def draw(self, generator: torch.Generator, batch: int):
        """``(anchors (B, A, D), references (B, A, R, D))`` int64, x-first."""
        anchors = torch.stack([
            torch.randint(lo, hi, (batch, self.n_anchors), generator=generator,
                          device=self.device)
            for lo, hi in zip(self.lows, self.highs)], dim=-1)
        idx = torch.randint(0, self.offsets.shape[0], (batch, self.n_anchors, self.n_refs),
                            generator=generator, device=self.device)
        return anchors, anchors[:, :, None, :] + self.offsets[idx]


PAIRS = 17  # the pair draws' stream of a run's seed


def step_generator(seed: int, step: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(generator_seed(seed, PAIRS, step))
    return gen


def gather(offsets: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Embeddings at x-first ``coords`` (B, P, D) of channels-first offsets
    (B, D, *spatial): the offset there plus the coordinate."""
    B, D = offsets.shape[:2]
    spatial = offsets.shape[2:]
    flat = offsets.reshape(B, D, -1)
    idx = torch.zeros(coords.shape[:-1], dtype=torch.long, device=offsets.device)
    stride = 1
    for d in range(len(spatial)):
        idx = idx + coords[..., d] * stride
        stride *= spatial[len(spatial) - 1 - d]
    got = torch.gather(flat, 2, idx[:, None, :].expand(B, D, idx.shape[1]))
    return got.transpose(1, 2) + coords.to(got.dtype)


def oce_loss(offsets, anchors, references, temperature: float, regularizer_weight: float):
    B, A, R, D = references.shape
    e_a = gather(offsets, anchors)  # (B, A, D)
    e_r = gather(offsets.detach(), references.reshape(B, A * R, D)).reshape(B, A, R, D)
    diff = e_a[:, :, None, :] - e_r
    oce = (1.0 - torch.exp(-(diff * diff).sum(-1) / temperature)).sum()
    reg = regularizer_weight * R * torch.linalg.vector_norm(e_a, dim=-1).sum()
    return oce + reg


class Adam:
    """Adam with the L2 decay added to the gradient before the moments."""

    def __init__(self, params: List[torch.Tensor], lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd, self.betas, self.eps = params, lr, weight_decay, betas, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0
        self.first_grads: Optional[List[torch.Tensor]] = None

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        grads = [p.grad + self.wd * p for p in self.params]
        if self.first_grads is None:
            self.first_grads = [g.clone() for g in grads]
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / (1 - b1**self.t)
            v_hat = v / (1 - b2**self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
            p.grad = None


def run_steps(weights: Dict[str, torch.Tensor], model: dict, train: dict,
              batches: List[torch.Tensor], seed: int, device, fault: Optional[str] = None):
    """The first ``len(batches)`` steps from ``weights``: ``(losses, first
    gradients as the optimizer takes them, parameters after the steps)``,
    by name. ``batches`` are ``(B, C, *crop)`` float32.

    ``fault`` plants one of the faults a check has to catch: ``"half"``
    leaves half of the batch out and takes the mean over the rest (the loss
    doubled), ``"altered"`` doubles the gradient of the median-sized leaf
    where the backward produces it."""
    names = list(weights)
    params = [weights[n].detach().clone().requires_grad_(True) for n in names]
    named = dict(zip(names, params))
    opt = Adam(params, train["initial_learning_rate"], train["weight_decay"])
    out_shape = None
    losses = []
    for i, raw in enumerate(batches):
        B = raw.shape[0]
        offsets = forward(named, model, raw)
        if out_shape is None:
            out_shape = tuple(offsets.shape[2:])
            pairs = Pairs(out_shape, train["density"], train["kappa"], device)
        anchors, references = pairs.draw(step_generator(seed, i, device), B)
        scale = 1.0
        if fault == "half":
            keep = B // 2
            offsets, anchors, references = offsets[:keep], anchors[:keep], references[:keep]
            scale = B / keep
        loss = scale * oce_loss(offsets, anchors, references, train["temperature"],
                                train["regularizer_weight"])
        loss.backward()
        if fault == "altered":
            sizes = sorted(range(len(params)), key=lambda k: params[k].numel())
            params[sizes[len(sizes) // 2]].grad *= 2
        losses.append(float(loss.detach()))
        opt.step()
    first = {n: g.detach() for n, g in zip(names, opt.first_grads)}
    final = {n: p.detach() for n, p in zip(names, params)}
    return losses, first, final
