"""Distance-weighted negative sampling — the canonical miner.

Port of vit_reranking_tpu/miners/distance.py (reference batchminer/
distance.py:13-73): negatives drawn from the inverse unit-sphere distance
distribution, positives uniformly from the anchor's class, one batched draw
each.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import Triplets, categorical, inverse_sphere_log_q, pdist, uniform_choice


class BatchMiner:
    name = "distance"

    def __init__(self, opt=None):
        self.lower_cutoff = getattr(opt, "miner_distance_lower_cutoff", 0.5)
        self.upper_cutoff = getattr(opt, "miner_distance_upper_cutoff", 1.4)
        self.dim = 128  # hardcoded in the reference (distance.py:20)

    def masks(self, batch: torch.Tensor, labels: torch.Tensor):
        """(log_q (B, B) of the negatives, positive mask (B, B))."""
        B = batch.shape[0]
        d = torch.clamp(pdist(batch.detach()), min=self.lower_cutoff)
        same = labels[:, None] == labels[None, :]
        eye = torch.eye(B, dtype=torch.bool, device=batch.device)
        log_q = inverse_sphere_log_q(d, same, dim=self.dim)
        # positives: uniform over same-class (self excluded when another exists)
        pos_mask = same & ~eye
        has_other = pos_mask.any(dim=-1, keepdim=True)
        return log_q, torch.where(has_other, pos_mask, eye)

    def __call__(self, batch: torch.Tensor, labels: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> Triplets:
        B = batch.shape[0]
        log_q, pos_mask = self.masks(batch, labels)
        negative = categorical(generator, log_q)
        positive = uniform_choice(generator, pos_mask)
        anchor = torch.arange(B, device=batch.device)
        # the reference appends a triplet for every anchor (self counts as a
        # positive), so every triplet is valid
        valid = torch.ones(B, dtype=torch.bool, device=batch.device)
        return Triplets(anchor, positive, negative, valid)
