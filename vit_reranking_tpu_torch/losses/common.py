"""Shared loss utilities (port of vit_reranking_tpu/losses/common.py)."""

from __future__ import annotations

import torch
import torch.nn as nn


def pair_norm(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise euclidean distance ||a - b|| with eps inside the sqrt, which
    keeps the gradient finite at coincident pairs."""
    return torch.sqrt(torch.sum((a - b) ** 2, dim=-1) + eps)


class Criterion(nn.Module):
    """Base criterion: a module whose parameters (none by default) are the
    loss's learnable state, trained with ``lr`` as their group's learning
    rate.  The class flags mirror the reference's wiring
    (criteria/__init__.py:16-62)."""

    ALLOWED_MINING_OPS = None
    REQUIRES_BATCHMINER = False
    name = "base"
    lr = None

    def forward(self, batch, labels, generator=None, **kwargs):
        raise NotImplementedError
