"""Seeded inputs and weights, made on the device in a few large calls.

- :func:`nuclei` draws bright blobs on a dark background, as the repo's
  ``examples/2d/01-data.py`` and ``examples/3d/01-data.py`` make them
  (``tests/synthetic.py:make_blobs``): 12 disjoint blobs an image, radius
  4-9% of the size, a Gaussian profile of peak 0.6-1.0, clipped Gaussian
  noise of 0.02, stored as uint8.
- :func:`weights` draws every conv's weight from N(0, 2 / fan_in) (the
  reference's Kaiming-normal init) and its bias from
  U(-1/sqrt(fan_in), 1/sqrt(fan_in)), in two draws for the whole model.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .reference.unet import param_shapes

NUM_BLOBS = 12


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for one of a run's streams (inputs,
    weights, ...), seeded by a SeedSequence hash of ``(seed, stream)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(seed), int(stream)])
                        .generate_state(1, np.uint64)[0]))
    return gen


def nuclei(num: int, size, device, gen: torch.Generator) -> np.ndarray:
    """``(num, 1, *size)`` uint8 images."""
    size = tuple(int(s) for s in size)
    ndim = len(size)
    s0 = min(size)
    draws = torch.rand((num, NUM_BLOBS, 2 + ndim), generator=gen, device=device)
    radius = s0 * (0.04 + 0.05 * draws[..., 0])
    intensity = 0.6 + 0.4 * draws[..., 1]
    ext = torch.tensor(size, dtype=torch.float32, device=device)
    centers = radius[..., None] + draws[..., 2:] * (ext - 2 * radius[..., None])
    noise = torch.randn((num, *size), generator=gen, device=device).mul_(0.02).clamp_(min=0)
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=device)
                             for s in size], indexing="ij")
    raw = torch.zeros((num, *size), dtype=torch.float32, device=device)
    taken = torch.zeros((num, *size), dtype=torch.bool, device=device)
    for b in range(NUM_BLOBS):
        dist2 = torch.zeros((num, *size), dtype=torch.float32, device=device)
        for d in range(ndim):
            c = centers[:, b, d].reshape((num,) + (1,) * ndim)
            dist2 += (grids[d][None] - c) ** 2
        r = radius[:, b].reshape((num,) + (1,) * ndim)
        mask = dist2 < r**2
        # keep blobs disjoint: a blob that touches an earlier one is skipped
        free = ~(mask & taken).flatten(1).any(dim=1)
        mask &= free.reshape((num,) + (1,) * ndim)
        taken |= mask
        peak = intensity[:, b].reshape((num,) + (1,) * ndim)
        blob = peak * torch.exp(-dist2 / (2 * (r / 1.5) ** 2))
        raw = torch.where(mask, torch.maximum(raw, blob), raw)
    raw = ((raw + noise).clamp(0, 1) * 255).to(torch.uint8)
    return raw[:, None].cpu().numpy()


def weights(model: dict, ndim: int, device, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Float32 weights by funlib's names, on ``device``."""
    shapes = param_shapes(model, ndim)
    w_shapes = [s for n, s in shapes if n.endswith(".weight")]
    b_shapes = [s for n, s in shapes if n.endswith(".bias")]
    normal = torch.randn(sum(math.prod(s) for s in w_shapes), generator=gen, device=device)
    uniform = torch.rand(sum(math.prod(s) for s in b_shapes), generator=gen, device=device)
    out = {}
    wi = bi = 0
    fan_in = None
    for name, shape in shapes:
        n = math.prod(shape)
        if name.endswith(".weight"):
            fan_in = math.prod(shape[1:])
            out[name] = (normal[wi:wi + n] * math.sqrt(2.0 / fan_in)).reshape(shape)
            wi += n
        else:
            bound = 1.0 / math.sqrt(fan_in)
            out[name] = ((uniform[bi:bi + n] * 2 - 1) * bound).reshape(shape)
            bi += n
    return out
