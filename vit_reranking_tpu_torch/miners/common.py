"""Shared miner utilities: distance matrices, masked categorical sampling.

Port of vit_reranking_tpu/miners/common.py.  Categorical draws use the
Gumbel-max rule on uniforms from a ``torch.Generator`` (or the global
generator when none is given), on the device of the logits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Triplets(NamedTuple):
    """Index triplets (anchor, positive, negative) with a validity mask, each
    of length B (reference batchminer/distance.py:43)."""

    anchor: torch.Tensor
    positive: torch.Tensor
    negative: torch.Tensor
    valid: torch.Tensor


def pdist(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Euclidean distance matrix, reference batchminer/distance.py:69-73:
    sqrt(clamp(|a|^2 + |b|^2 - 2ab, min=eps)), the product in full f32."""
    prod = torch.matmul(x.float(), x.float().T)
    sq = torch.diagonal(prod)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * prod, min=eps)
    return torch.sqrt(d2)


def categorical(generator: Optional[torch.Generator], logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``logits`` (B, N) (unnormalised log-probabilities,
    -inf excluded), by the Gumbel-max rule."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def masked_categorical(generator: Optional[torch.Generator], log_probs: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Per-row categorical draw restricted to ``mask`` (B, N).  A row with an
    empty mask draws uniformly over all N (the caller gates on validity)."""
    logits = torch.where(mask, log_probs, torch.full_like(log_probs, float("-inf")))
    safe = torch.where(mask.any(dim=-1, keepdim=True), logits, torch.zeros_like(logits))
    return categorical(generator, safe)


def uniform_choice(generator: Optional[torch.Generator], mask: torch.Tensor) -> torch.Tensor:
    """Uniform draw from each row's True entries."""
    return masked_categorical(generator, torch.zeros(mask.shape, device=mask.device), mask)


def inverse_sphere_log_q(dists: torch.Tensor, same_label: torch.Tensor,
                         dim: int = 128) -> torch.Tensor:
    """log of the inverse unit-sphere distance distribution (reference
    batchminer/distance.py:51-66; ``dim`` is 128 there whatever the embedding
    width).  Per-row max-shifted log-probabilities, same-label entries -inf."""
    d = dists
    # the clamp keeps the log finite where d exceeds 2 by float error
    log_q = (2.0 - dim) * torch.log(d) - ((dim - 3) / 2.0) * torch.log(
        torch.clamp(1.0 - 0.25 * d**2, min=1e-45)
    )
    log_q = torch.where(same_label, torch.zeros_like(log_q), log_q)
    log_q = log_q - torch.amax(log_q, dim=-1, keepdim=True)
    return torch.where(same_label, torch.full_like(log_q, float("-inf")), log_q)
