"""Object-centric-embedding (OCE) loss.

Port of ``cellulus_tpu/criterions/oce_loss.py`` (reference
``criterions/oce_loss.py:53-63``):

    loss = sum_pairs (1 - exp(-||e_a - sg(e_r)||^2 / tau))
         + lambda_reg * sum_pairs ||e_a||

The reference embedding is detached, and the loss is an un-normalized sum
over all sampled pairs (not a mean).
"""

from __future__ import annotations

from typing import Tuple

import torch


def oce_loss(
    anchor_embedding: torch.Tensor,
    reference_embedding: torch.Tensor,
    temperature: float,
    regularizer_weight: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compute ``(total, oce, regularization)``.

    Args:
        anchor_embedding: ``(..., D)`` absolute embeddings at anchor pixels.
        reference_embedding: same shape, at reference pixels; no gradient
            flows through it.
    """
    diff = anchor_embedding - reference_embedding.detach()
    sq_dist = (diff * diff).sum(dim=-1)
    oce = (1.0 - torch.exp(-sq_dist / temperature)).sum()
    reg = regularizer_weight * torch.linalg.vector_norm(anchor_embedding, dim=-1).sum()
    return oce + reg, oce, reg
