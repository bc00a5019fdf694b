"""Margin loss with trainable per-class boundary beta — the canonical
baseline (port of vit_reranking_tpu/losses/margin.py, reference
criteria/margin.py:11-73): one gathered batch computation over the mined
triplets."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .common import Criterion, pair_norm

ALL_MINERS = [
    "random", "semihard", "softhard", "distance", "rho_distance",
    "npair", "parametric", "lifted", "random_distance", "intra_random",
]


class MarginLoss(Criterion):
    ALLOWED_MINING_OPS = ALL_MINERS
    REQUIRES_BATCHMINER = True
    name = "margin"

    def __init__(self, opt, batchminer):
        super().__init__()
        self.n_classes = opt.n_classes
        self.margin = getattr(opt, "loss_margin_margin", 0.2)
        self.nu = getattr(opt, "loss_margin_nu", 0.0)
        self.beta_constant = getattr(opt, "loss_margin_beta_constant", False)
        self.beta_val = getattr(opt, "loss_margin_beta", 1.2)
        self.lr = getattr(opt, "loss_margin_beta_lr", 0.0005)
        self.batchminer = batchminer
        if not self.beta_constant:
            self.beta = nn.Parameter(torch.full((self.n_classes,), float(self.beta_val)))

    def forward(self, batch: torch.Tensor, labels: torch.Tensor,
                generator: Optional[torch.Generator] = None, **kwargs) -> torch.Tensor:
        trip = self.batchminer(batch, labels, generator)
        a = batch[trip.anchor]
        p = batch[trip.positive]
        n = batch[trip.negative]

        d_ap = pair_norm(a, p, eps=1e-8)
        d_an = pair_norm(a, n, eps=1e-8)
        beta = self.beta_val if self.beta_constant else self.beta[labels[trip.anchor]]

        pos_loss = torch.relu(d_ap - beta + self.margin)
        neg_loss = torch.relu(beta - d_an + self.margin)
        v = trip.valid.float()
        pair_count = torch.sum(((pos_loss > 0) | (neg_loss > 0)).float() * v)
        total = torch.sum((pos_loss + neg_loss) * v)
        loss = torch.where(pair_count == 0.0, total, total / torch.clamp(pair_count, min=1.0))
        if self.nu:
            loss = loss + self.nu * torch.sum(torch.abs(self.beta))
        return loss
