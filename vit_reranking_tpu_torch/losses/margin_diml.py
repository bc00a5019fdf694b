"""Margin loss over OT structural distances (port of
vit_reranking_tpu/losses/margin_diml.py, reference criteria/margin_diml.py).

Mining runs on the L2-normed pooled features (or the class token with
``--use_cls_token``); the margin hinge runs on the OT-weighted patch
distance of each mined pair, the (a, p) and (a, n) pairs each in one
batched call."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .common import Criterion
from .diml_ot import pair_wise_wdist
from .margin import ALL_MINERS


def _to_cr(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) or (B, C, R) -> (B, C, R)."""
    if x.ndim == 4:
        B, H, W, C = x.shape
        return x.reshape(B, H * W, C).transpose(1, 2)
    return x


class MarginDIMLLoss(Criterion):
    ALLOWED_MINING_OPS = ALL_MINERS
    REQUIRES_BATCHMINER = True
    name = "margin_diml"

    def __init__(self, opt, batchminer):
        super().__init__()
        self.n_classes = opt.n_classes
        self.margin = getattr(opt, "loss_margin_margin", 0.2)
        self.beta_constant = getattr(opt, "loss_margin_beta_constant", False)
        self.beta_val = getattr(opt, "loss_margin_beta", 1.2)
        self.lr = getattr(opt, "loss_margin_beta_lr", 0.0005)
        self.use_uniform = getattr(opt, "use_uniform", False)
        self.use_inverse = getattr(opt, "use_inverse", False)
        self.use_cls_token = getattr(opt, "use_cls_token", False)
        self.batchminer = batchminer
        if not self.beta_constant:
            self.beta = nn.Parameter(torch.full((self.n_classes,), float(self.beta_val)))

    def forward(self, batch: torch.Tensor, labels: torch.Tensor,
                generator: Optional[torch.Generator] = None, **kwargs) -> torch.Tensor:
        feats = _to_cr(batch)
        if self.use_cls_token:
            if "class_token" not in kwargs:
                raise KeyError("class_token not found")
            pooled = kwargs["class_token"]
        else:
            pooled = torch.mean(feats, dim=-1)
        pooled = pooled / torch.clamp(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True),
                                      min=1e-12)

        trip = self.batchminer(pooled, labels, generator)
        a, p, n = feats[trip.anchor], feats[trip.positive], feats[trip.negative]
        kw = dict(use_uniform=self.use_uniform, use_inverse=self.use_inverse)
        if self.use_cls_token:
            am, pm, nm = pooled[trip.anchor], pooled[trip.positive], pooled[trip.negative]
            d_ap = pair_wise_wdist(a, p, am, pm, **kw)
            d_an = pair_wise_wdist(a, n, am, nm, **kw)
        else:
            d_ap = pair_wise_wdist(a, p, **kw)
            d_an = pair_wise_wdist(a, n, **kw)

        beta = self.beta_val if self.beta_constant else self.beta[labels[trip.anchor]]
        pos_loss = torch.relu(d_ap - beta + self.margin)
        neg_loss = torch.relu(beta - d_an + self.margin)
        # triplets whose OT plan went NaN are dropped (margin_diml.py:101-102)
        ok = trip.valid & torch.isfinite(d_ap) & torch.isfinite(d_an)
        pos_loss = torch.where(ok, pos_loss, torch.zeros_like(pos_loss))
        neg_loss = torch.where(ok, neg_loss, torch.zeros_like(neg_loss))
        pair_count = torch.sum(((pos_loss > 0) | (neg_loss > 0)).float())
        total = torch.sum(pos_loss + neg_loss)
        return torch.where(pair_count == 0.0, total, total / torch.clamp(pair_count, min=1.0))
