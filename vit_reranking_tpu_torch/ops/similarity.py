"""DIML structural-similarity rerank, rollout-marginal method (PyTorch).

Port of the rollout path of vit_reranking_tpu/ops/similarity.py (reference
utilities/diml.py:77-147, 323-366): the eager path that
``rerank_evaluate(use_fused=False)`` takes.  The other ``calc_similarity*``
methods (cross-attention, featvit, qk, cam, mhvit, distance) come with later
slices of the port.

Conventions (the JAX package's, for parity):
  * anchor (query) patch features:  ``(..., C, R)``  — channels x patches
  * feature bank (gallery) tile:    ``(..., N, C, R)``
  * patch-similarity tensor:        ``S[n, s, m] = fb[n, :, s] . anchor[:, m]``
    (einsum 'cm,ncs->nsm', reference diml.py:100)
  * marginal u is over gallery patches (rows), v over anchor patches (cols)
  * OT kernel: ``K = exp(-(1 - S) / ot_temp)``, ot_temp default 0.05
  * rerank score: ``sum(T * S)`` over both patch axes
Leading ``...`` axes are independent queries (what ``vmap`` gives the JAX
version): each query's candidates share one Sinkhorn exit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .sinkhorn import sinkhorn, sinkhorn_partial

_EPS = 1e-5


class OTAux(NamedTuple):
    """Visualization payload mirroring the reference's `(u, v, T, sim_r, cc)` tuple."""

    u: torch.Tensor
    v: torch.Tensor
    T: torch.Tensor
    sim_r: torch.Tensor
    cc: Optional[torch.Tensor]


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize semantics: x / max(||x||, eps)."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def global_similarity(anchor_center: torch.Tensor, fb_center: torch.Tensor) -> torch.Tensor:
    """Stage-0 global cosine similarity: (..., C) x (..., N, C) -> (..., N)
    (reference diml.py:84)."""
    return torch.matmul(fb_center, anchor_center.unsqueeze(-1)).squeeze(-1)


def _normalized_marginal(att: torch.Tensor) -> torch.Tensor:
    return att / (torch.sum(att, dim=-1, keepdim=True) + _EPS)


def patch_similarity(anchor: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """S[..., n, s, m] = fb patch s . anchor patch m  (reference diml.py:100)."""
    return torch.matmul(fb.transpose(-1, -2), anchor.unsqueeze(-3))


def _ot_plan(S, u, v, ot_temp, ot_part, iters, thresh, batch_dims):
    K = torch.exp(-(1.0 - S) / ot_temp)
    if ot_part > 0.999:
        T = sinkhorn(K, u, v, iters=iters, thresh=thresh, batch_dims=batch_dims)
        return T, T
    T_ext = sinkhorn_partial(
        K, u, v, ot_part=ot_part, iters=iters, thresh=thresh, batch_dims=batch_dims
    )
    R = S.shape[-1]
    return T_ext[..., :R, :R], T_ext


def calc_similarity_rollout(
    anchor_center: torch.Tensor,
    anchor: torch.Tensor,
    anchor_rollout: torch.Tensor,
    fb_center: torch.Tensor,
    fb: torch.Tensor,
    fb_rollout: torch.Tensor,
    stage: int,
    use_uniform: bool = False,
    ot_temp: float = 0.05,
    ot_part: float = 1.0,
    iters: int = 100,
    thresh: float = 1e-1,
) -> Tuple[torch.Tensor, Optional[OTAux]]:
    """Rerank with attention-rollout saliency marginals — the `--use_rollout`
    flagship path (reference utilities/diml.py:323-366, readme.md:11).

    ``anchor_rollout (..., R)`` and ``fb_rollout (..., N, R)`` are per-image
    rollout saliency vectors (see ops/rollout.py).
    """
    if stage == 0:
        return global_similarity(anchor_center, fb_center), None

    *lead, N, _, R = fb.shape
    S = patch_similarity(anchor.float(), fb.float())
    if use_uniform:
        u = torch.full((*lead, N, R), 1.0 / R, device=fb.device)
        v = u
    else:
        u = _normalized_marginal(torch.relu(fb_rollout.float()))
        v_att = torch.relu(anchor_rollout.float()).unsqueeze(-2).expand(*lead, N, R)
        v = _normalized_marginal(v_att)
    T, T_ext = _ot_plan(S, u, v, ot_temp, ot_part, iters, thresh, batch_dims=len(lead))
    sim_r = T * S
    sim = torch.sum(sim_r, dim=(-2, -1))
    T_out = T if ot_part > 0.999 else T_ext
    return sim, OTAux(u, v, T_out, sim_r, None)
