"""DIML structural-similarity rerank (PyTorch): the eager path that
``rerank_evaluate(use_fused=False)`` takes.

Port of vit_reranking_tpu/ops/similarity.py for the featvit
(cross-attention marginals, ``calc_similarity``, reference
utilities/diml.py:77-147), qk (``calc_similarity_qk``, diml.py:206-320) and
rollout (``calc_similarity_rollout``, diml.py:323-366) methods.  The cam,
mhvit and distance methods come with later slices of the port.

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


def cross_attention_marginals(
    anchor: torch.Tensor,
    anchor_center: torch.Tensor,
    fb: torch.Tensor,
    fb_center: torch.Tensor,
    *,
    use_uniform: bool = False,
    use_inverse: bool = False,
    use_minus: bool = False,
    use_soft: bool = False,
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """OT marginals (u over gallery patches, v over anchor patches) from
    cross-attention saliency: anchor (..., C, R), anchor_center (..., C), fb
    (..., N, C, R), fb_center (..., N, C).

    Variants mirror reference diml.py:104-133: uniform 1/R; minus
    ``1 - relu(att)`` (overrides inverse, diml.py:80-81); inverse
    ``exp(-relu(att) / temperature)``; soft ``softmax(att)``; default
    ``relu(att)``; each normalized.  Returns ``(u, v, cc)`` with cc the raw
    cross-correlation some variants keep for visualization (else None).
    """
    *lead, N, _, R = fb.shape
    # saliency of each gallery patch w.r.t. the anchor's global embedding
    att_u = torch.matmul(anchor_center.float()[..., None, None, :], fb.float())[..., 0, :]
    # saliency of each anchor patch w.r.t. each gallery's global embedding
    att_v = torch.matmul(fb_center.float(), anchor.float())
    cc = None
    if use_uniform:
        u = torch.full((*lead, N, R), 1.0 / R, device=fb.device)
        v = torch.full((*lead, N, R), 1.0 / R, device=fb.device)
    elif use_minus:
        cc = att_u
        u = _normalized_marginal(1.0 - torch.relu(att_u))
        v = _normalized_marginal(1.0 - torch.relu(att_v))
    elif use_inverse:
        u = _normalized_marginal(torch.exp(-torch.relu(att_u) / temperature))
        v = _normalized_marginal(torch.exp(-torch.relu(att_v) / temperature))
    elif use_soft:
        cc = att_v
        u = _normalized_marginal(torch.softmax(att_u, dim=-1))
        v = _normalized_marginal(torch.softmax(att_v, dim=-1))
    else:
        cc = att_v
        u = _normalized_marginal(torch.relu(att_u))
        v = _normalized_marginal(torch.relu(att_v))
    return u, v, cc


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


def calc_similarity(
    anchor: torch.Tensor,
    anchor_center: torch.Tensor,
    fb: torch.Tensor,
    fb_center: torch.Tensor,
    stage: int,
    use_uniform: bool = False,
    use_inverse: bool = False,
    temperature: float = 1.0,
    use_cls_token: bool = False,
    ot_temp: float = 0.05,
    use_minus: bool = False,
    ot_part: float = 1.0,
    use_soft: bool = False,
    iters: int = 100,
    thresh: float = 1e-1,
) -> Tuple[torch.Tensor, Optional[OTAux]]:
    """The featvit rerank (reference utilities/diml.py:77-147).

    stage 0: global cosine similarity of centers.  stage 1: OT-weighted
    patch similarity ``sum(T * S)`` with marginals from cross-attention
    saliency (see :func:`cross_attention_marginals`); the centers are the
    patch means unless ``use_cls_token``.
    """
    if stage == 0:
        return global_similarity(anchor_center, fb_center), None

    *lead, N, _, R = fb.shape
    if not use_cls_token:
        anchor_center = torch.mean(anchor, dim=-1)
        fb_center = torch.mean(fb, dim=-1)
    anchor_center = l2_normalize(anchor_center.float())
    fb_center = l2_normalize(fb_center.float())
    S = patch_similarity(anchor.float(), fb.float())
    u, v, cc = cross_attention_marginals(
        anchor, anchor_center, fb, fb_center, use_uniform=use_uniform,
        use_inverse=use_inverse, use_minus=use_minus, use_soft=use_soft,
        temperature=temperature,
    )
    T, T_ext = _ot_plan(S, u, v, ot_temp, ot_part, iters, thresh, batch_dims=len(lead))
    sim_r = T * S
    sim = torch.sum(sim_r, dim=(-2, -1))
    return sim, OTAux(u, v, T if ot_part > 0.999 else T_ext, sim_r, cc)


def calc_similarity_qk(
    anchor_center: torch.Tensor,
    anchor: torch.Tensor,
    anchor_q: torch.Tensor,
    fb_center: torch.Tensor,
    fb: torch.Tensor,
    fb_k: torch.Tensor,
    stage: int,
    use_uniform: bool = False,
    use_exp: bool = False,
    temperature: float = 1.0,
    scale: float = 1.0 / 8.0,
    use_ot: bool = True,
    iters: int = 100,
    thresh: float = 1e-1,
) -> Tuple[torch.Tensor, Optional[OTAux]]:
    """Marginals and OT kernel from the raw q/k attention of a chosen
    transformer block (reference calc_similarity_vit, diml.py:206-263,
    scale 1/8, and calc_similarity_cvt, diml.py:266-320, scale 1).

    ``anchor_q (..., heads, R+1, D)`` is the anchor's query projection,
    ``fb_k (..., N, heads, R+1, D)`` the candidates' key projections; both
    are averaged over heads and L2-normalized.  ``use_ot=False`` takes the
    dual-softmax plan ``softmax(dp, -1) * softmax(dp, -2)`` (diml.py:309-312).
    """
    if stage == 0:
        return global_similarity(anchor_center, fb_center), None

    *lead, N, _, R = fb.shape
    S = patch_similarity(anchor.float(), fb.float())
    q = l2_normalize(torch.mean(anchor_q.float(), dim=-3))  # (..., R+1, D)
    k = l2_normalize(torch.mean(fb_k.float(), dim=-3))  # (..., N, R+1, D)
    # dp[..., n, s, m] = k[n, s] . q[m] * scale  ('mc,nsc->nsm')
    dp = torch.matmul(k, q.unsqueeze(-3).transpose(-1, -2)) * scale
    dp_patch = dp[..., 1:, 1:]
    if use_ot:
        K = torch.exp(-(1.0 - dp_patch) / 0.05)
        if use_uniform:
            u = torch.full((*lead, N, R), 1.0 / R, device=fb.device)
            v = torch.full((*lead, N, R), 1.0 / R, device=fb.device)
        elif use_exp:
            u = _normalized_marginal(torch.exp(-torch.relu(dp[..., 1:, 0]) / temperature))
            v = _normalized_marginal(torch.exp(-torch.relu(dp[..., 0, 1:]) / temperature))
        else:
            u = _normalized_marginal(torch.relu(dp[..., 1:, 0]))
            v = _normalized_marginal(torch.relu(dp[..., 0, 1:]))
        T = sinkhorn(K, u, v, iters=iters, thresh=thresh, batch_dims=len(lead))
    else:
        u = torch.full((*lead, N, R), 1.0 / R, device=fb.device)
        v = torch.full((*lead, N, R), 1.0 / R, device=fb.device)
        T = torch.softmax(dp_patch, dim=-1) * torch.softmax(dp_patch, dim=-2)
    sim_r = T * S
    sim = torch.sum(sim_r, dim=(-2, -1))
    return sim, OTAux(u, v, T, sim_r, None)


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
