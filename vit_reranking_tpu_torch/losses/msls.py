"""MSLS place-recognition losses.

Port of vit_reranking_tpu/losses/msls.py: the triplet loss of the MSLS
baseline epoch (reference training_tools/train_epoch.py:136-141).  The
distillation losses (supervised contrastive, relational and Hinton KD,
smooth L1) and the cross-batch-memory triplet come with the distillation
slice of the port.
"""

from __future__ import annotations

import torch


def msls_triplet_loss(q: torch.Tensor, p: torch.Tensor, negs: torch.Tensor,
                      margin: float = 0.1) -> torch.Tensor:
    """torch ``TripletMarginLoss(margin ** 0.5, p=2)`` over each query's
    positive and nNeg negatives, averaged over all (query, negative) pairs.
    q, p: (B, d); negs: (B, nNeg, d)."""
    d_ap = torch.linalg.vector_norm(q - p, dim=-1)  # (B,)
    d_an = torch.linalg.vector_norm(q[:, None, :] - negs, dim=-1)  # (B, nNeg)
    return torch.mean(torch.relu(d_ap[:, None] - d_an + margin**0.5))
