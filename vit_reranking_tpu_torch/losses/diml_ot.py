"""Training-time OT machinery of the structural (DIML) losses.

Port of vit_reranking_tpu/losses/diml_ot.py:23-93 (reference
criteria/margin_diml.py:50-125): the batch-paired cross-attention
marginals and the OT-weighted patch distance of each (x, y) pair.  The
plan is computed under ``torch.no_grad()`` from the detached kernel, as
the JAX package computes it under ``stop_gradient``, with the plain
``ops/sinkhorn.py::sinkhorn`` (no port kernel: the JAX package runs no
Pallas kernel here either).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.sinkhorn import sinkhorn

_EPS = 1e-5


def _norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=1e-12)


def training_cross_attention(x: torch.Tensor, y: torch.Tensor, x_mean: torch.Tensor,
                             y_mean: torch.Tensor,
                             use_inverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Marginals from batch-paired cross attention (margin_diml.py:56-67):
    x, y (B, C, R), x_mean, y_mean (B, C) -> u, v (B, R).  The training
    variant's ``use_inverse`` is ``1 - att``."""
    att = torch.relu(torch.einsum("nc,ncr->nr", x_mean, y))
    if use_inverse:
        att = 1.0 - att
    u = att / (torch.sum(att, dim=1, keepdim=True) + _EPS)
    att = torch.relu(torch.einsum("nc,ncr->nr", y_mean, x))
    if use_inverse:
        att = 1.0 - att
    v = att / (torch.sum(att, dim=1, keepdim=True) + _EPS)
    return u, v


def pair_wise_wdist(x: torch.Tensor, y: torch.Tensor, x_mean: Optional[torch.Tensor] = None,
                    y_mean: Optional[torch.Tensor] = None, is_positive: bool = True,
                    use_uniform: bool = False, use_inverse: bool = False, eps: float = 0.05,
                    iters: int = 100) -> torch.Tensor:
    """OT-weighted pairwise patch L2 distance (margin_diml.py:69-108): x, y
    (B, C, R) -> (dist_patch + dist_global) / 2, (B,).

    The plan of a positive pair is Sinkhorn's on exp(-(1 - sim) / eps) with
    the marginals in the order (v, u), as the reference passes them; the
    whole batch of pairs is one problem for the exit test (one mean
    residual), as the JAX package's un-vmapped call.  Negatives use T =
    ones.  A NaN plan (a zero-mass marginal) gives a NaN distance; the
    caller masks it."""
    B, C, R = x.shape
    if x_mean is None:
        x_mean = torch.mean(x, dim=2)
    if y_mean is None:
        y_mean = torch.mean(y, dim=2)
    x, y = _norm(x, 1), _norm(y, 1)
    x_mean, y_mean = _norm(x_mean, 1), _norm(y_mean, 1)

    diff = x[:, :, :, None] - y[:, :, None, :]  # (B, C, Rx, Ry)
    dist1 = torch.sqrt(torch.sum(diff**2, dim=1) + 1e-6)
    dist2 = torch.sqrt(torch.sum((x_mean - y_mean) ** 2, dim=1) + 1e-6)

    if is_positive:
        with torch.no_grad():
            xd, yd = x.detach(), y.detach()
            sim = torch.einsum("bcs,bcm->bsm", xd, yd)
            if use_uniform:
                u = torch.full((B, R), 1.0 / R, device=x.device)
                v = torch.full((B, R), 1.0 / R, device=x.device)
            else:
                u, v = training_cross_attention(xd, yd, x_mean.detach(), y_mean.detach(),
                                                use_inverse)
            T = sinkhorn(torch.exp(-(1.0 - sim) / eps), v, u, iters=iters)
    else:
        T = torch.ones_like(dist1)
    d1 = torch.sum(T * dist1, dim=(1, 2))
    return (d1 + dist2) / 2.0
