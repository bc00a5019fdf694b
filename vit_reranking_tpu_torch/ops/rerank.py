"""Fused Sinkhorn rerank of each query against its top-K candidates.

Port of vit_reranking_tpu/ops/rerank_pallas.py: the rollout, featvit
(cross-attention marginals) and qk (attention-map cost) methods.  The patch
similarity S of every (query, candidate) pair is one large product outside
the kernel (as the JAX package leaves it to XLA); kernel K1
(``csrc/sinkhorn_score.cu``, replacing the TPU kernel
``_sinkhorn_score_kernel``, rerank_pallas.py:97-234) then runs the whole
Sinkhorn loop and the final ``sum(T * S)`` per pair, reading S once.  The qk
method builds the OT kernel from a separate cost, the pair's q.k attention
map (the TPU kernel's ``has_cost`` mode, rerank_pallas.py:115-127), while the
score still contracts against S.

Early exit, as in the JAX package: full OT freezes each pair on its own mean
residual (rank-identical to the reference's batch exit); partial OT freezes
one query's K candidates together on their batch-mean residual
(the reference rule, utilities/diml.py:50-52).  For
K > ``PAIR_CHUNK`` the JAX kernel splits a query's candidates into
128-pair chunks, wrap-padded with the query's own candidates, and each chunk
exits on its own mean; the port reproduces that rule so the two compare.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import native
from .similarity import cross_attention_marginals, l2_normalize
from .sinkhorn import extend_dustbin

# pairs per exit group for K > PAIR_CHUNK under group exit (the TPU kernel's
# lane count, rerank_pallas.py:38, kept for its exit rule)
PAIR_CHUNK = 128


def _ot_inputs(S, u, v, ot_temp, ot_part, cost=None):
    """f32 kernel matrix (from ``cost`` when given, else from S), similarity
    and marginals, extended by the dustbin row/column under partial OT (S
    is 0 there)."""
    S = S.float()
    Km = torch.exp(-(1.0 - (S if cost is None else cost.float())) / ot_temp)
    u, v = u.float(), v.float()
    if ot_part <= 0.999:
        Km, u, v = extend_dustbin(Km, u, v, 1.0 - ot_part)
        S = F.pad(S, (0, 1, 0, 1))
    return Km, S, u, v


def sinkhorn_scores_plain(
    S: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    iters: int = 100,
    thresh: float = 1e-1,
    ot_temp: float = 0.05,
    ot_part: float = 1.0,
    group: int = 1,
    return_iters: bool = False,
    cost: Optional[torch.Tensor] = None,
):
    """``sum(T * S)`` per pair.

    Args:
      S: (P, R, R) patch similarity, rows = candidate patches, columns =
        query patches; f32 or bf16 (the loop math is f32 either way).
      u, v: (P, R) marginals over rows / columns.
      group: pairs ``[g*group, (g+1)*group)`` share one exit decision (their
        batch-mean residual); 1 = each pair exits on its own.
      return_iters: also return the scaling iterations each pair ran.
      cost: optional (P, R, R) map of S's shape and dtype that the OT kernel
        ``Km = exp(-(1 - cost) / ot_temp)`` comes from instead of S (the qk
        method); the score still contracts against S.
    Returns: (P,) f32 scores.
    """
    Km, S, u, v = _ot_inputs(S, u, v, ot_temp, ot_part, cost)
    P, RP = u.shape
    r = torch.ones_like(u)
    c = torch.ones_like(v)
    done = torch.zeros(P // group, dtype=torch.bool, device=u.device)
    ran = torch.zeros(P // group, dtype=torch.int32, device=u.device)
    for _ in range(iters):
        ran += (~done).int()
        d = done.repeat_interleave(group)[:, None]
        r_new = torch.where(d, r, u / torch.bmm(Km, c[:, :, None])[:, :, 0])
        c_new = torch.where(
            d, c, v / torch.bmm(Km.transpose(1, 2), r_new[:, :, None])[:, :, 0]
        )
        resid = torch.abs(r_new - r).reshape(P // group, group * RP)
        done = done | (torch.mean(resid, dim=1) < thresh)
        r, c = r_new, c_new
        if bool(done.all()):
            break
    # contract m first, then s (rerank_pallas.py:233-234)
    t1 = torch.sum((Km * S) * c[:, None, :], dim=2)
    scores = torch.sum(r * t1, dim=1)
    if return_iters:
        return scores, ran.repeat_interleave(group)
    return scores


_PLAN_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
              ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
              ctypes.POINTER(ctypes.c_longlong)]
_LAUNCH_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]
_LAYOUTS = {0: "warp", 1: "block", 2: "group-warp", 3: "group-block"}


def _plan(R: int, partial: bool, group: int) -> Tuple[Optional[str], int, int, int]:
    """:func:`kernel_layout`, and the largest group the group layouts hold
    at once (0 for group == 1)."""
    layout, smem = ctypes.c_int(), ctypes.c_longlong()
    limit, max_group = ctypes.c_int(), ctypes.c_longlong()
    fn = native.launcher("sinkhorn_score", "sinkhorn_score_plan", _PLAN_ARGS)
    native.check(fn(R, int(partial), group, ctypes.byref(layout), ctypes.byref(smem),
                    ctypes.byref(limit), ctypes.byref(max_group)), "sinkhorn_score_plan")
    return _LAYOUTS.get(layout.value), smem.value, limit.value, max_group.value


def kernel_layout(R: int, partial: bool, group: int) -> Tuple[Optional[str], int, int]:
    """``(layout, shared-memory bytes a block, the card's per-block limit)``
    that kernel K1 takes on the current card for R patches: "warp" (one warp
    a pair, R plus the dustbin at most 83), "block" (one block a pair, to
    239 on a 227 KB card), and for group > 1 "group-warp" (R plus the
    dustbin at most 83) or "group-block" (to 240): a group's pairs held the
    same ways over blocks resident at once, its exit reduced across them;
    None when no layout fits (R too large, or a group larger than the card
    holds at once)."""
    return _plan(R, partial, group)[:3]


def sinkhorn_scores(
    S: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    iters: int = 100,
    thresh: float = 1e-1,
    ot_temp: float = 0.05,
    ot_part: float = 1.0,
    group: int = 1,
    cost: Optional[torch.Tensor] = None,
    return_iters: bool = False,
):
    """:func:`sinkhorn_scores_plain`, as CUDA kernel K1 for CUDA tensors.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (``sinkhorn_scores.launches`` counts the launches,
    ``sinkhorn_scores.cost_launches`` those with a separate cost, mode (d),
    and ``sinkhorn_scores.group_launches`` those with group exit), or raises
    ``ValueError`` before the launch when no layout of the kernel fits R
    patches in the card's shared memory or holds a group of ``group`` pairs
    at once.  ``return_iters`` also returns the scaling iterations each
    pair ran, as the plain version does.
    """
    if S.device.type == "cpu":
        return sinkhorn_scores_plain(S, u, v, iters, thresh, ot_temp, ot_part, group,
                                     return_iters=return_iters, cost=cost)
    if S.device.type != "cuda":
        raise ValueError(f"sinkhorn_scores: unsupported device {S.device}")
    P, R, R2 = S.shape
    if R2 != R or S.dtype not in (torch.float32, torch.bfloat16) or not S.is_contiguous():
        raise ValueError(
            f"sinkhorn_scores: S must be a contiguous (P, R, R) f32/bf16 tensor, "
            f"got {tuple(S.shape)} {S.dtype}"
        )
    if cost is not None and (cost.shape != S.shape or cost.dtype != S.dtype
                             or not cost.is_contiguous() or cost.device != S.device):
        raise ValueError(
            f"sinkhorn_scores: cost must be contiguous, of S's shape and dtype on {S.device}, "
            f"got {tuple(cost.shape)} {cost.dtype}"
        )
    for name, t in (("u", u), ("v", v)):
        if t.shape != (P, R) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != S.device:
            raise ValueError(f"sinkhorn_scores: {name} must be contiguous f32 (P, R) on {S.device}")
    if group < 1 or P % group:
        raise ValueError(f"sinkhorn_scores: {P} pairs do not split into groups of {group}")
    partial = ot_part <= 0.999
    layout, smem, limit, max_group = _plan(R, partial, group)
    if layout is None:
        if group > 1 and smem <= limit:
            raise ValueError(
                f"sinkhorn_scores: a group of {group} pairs at R={R} is more than the "
                f"{max_group} pairs the card holds at once, the group layouts' limit"
            )
        raise ValueError(
            f"sinkhorn_scores: R={R} ({'partial' if partial else 'full'} OT, group {group}) "
            f"needs {smem} bytes of shared memory a block; the card's limit is {limit}"
        )
    n_groups = P // group
    out = torch.empty(P, dtype=torch.float32, device=S.device)
    ran = torch.empty(n_groups, dtype=torch.int32, device=S.device) if return_iters else None
    # the group layouts' teams: two sets of 64-bit residual slots each, at
    # most one team a group of at most one block a pair
    work = torch.zeros(2 * P, dtype=torch.int64, device=S.device) if group > 1 else None
    fn = native.launcher("sinkhorn_score", "sinkhorn_score_launch", _LAUNCH_ARGS)
    stream = torch.cuda.current_stream(S.device).cuda_stream
    native.check(
        fn(S.data_ptr(), None if cost is None else cost.data_ptr(),
           int(S.dtype == torch.bfloat16), u.data_ptr(), v.data_ptr(), out.data_ptr(),
           None if ran is None else ran.data_ptr(), None if work is None else work.data_ptr(),
           P, R, int(partial), 1.0 - ot_part, ot_temp, iters, thresh, group, stream),
        "sinkhorn_scores",
    )
    sinkhorn_scores.launches += 1
    sinkhorn_scores.cost_launches += int(cost is not None)
    sinkhorn_scores.group_launches += int(group > 1)
    if return_iters:
        return out, ran.repeat_interleave(group)
    return out


sinkhorn_scores.launches = 0
sinkhorn_scores.cost_launches = 0
sinkhorn_scores.group_launches = 0


def rollout_marginals(
    rollout_q: torch.Tensor, rollout_g: torch.Tensor, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, R) query + (Q, K, R) gathered gallery rollout saliency -> (u, v)
    marginals of the flagship path (reference diml.py:348-354)."""
    u = torch.relu(rollout_g.float())
    u = u / (torch.sum(u, dim=-1, keepdim=True) + eps)
    v_row = torch.relu(rollout_q.float())
    v_row = v_row / (torch.sum(v_row, dim=-1, keepdim=True) + eps)
    v = v_row[:, None, :].expand_as(u)
    return u, v


def fused_rerank_tile(
    anchors: torch.Tensor,
    fb_g: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    iters: int = 100,
    thresh: float = 1e-1,
    ot_temp: float = 0.05,
    ot_part: float = 1.0,
    stream_dtype: str = "float32",
    cost: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One query tile: anchors (T, C, R), fb_g (T, K, C, R), u/v (T, K, R).
    Returns (T, K) scores.

    ``stream_dtype="bfloat16"`` rounds S (and ``cost``) to bf16 before the
    kernel reads it (half the kernel's input bytes; the loop math stays f32).
    Partial OT makes one query's candidates exit together on their
    batch-mean residual; for K > PAIR_CHUNK the rule is per wrap-padded
    PAIR_CHUNK-pair chunk, as in the JAX package.  ``cost`` (T, K, R, R)
    optionally carries the map the OT kernel comes from (the qk method's
    attention map); the score still contracts against S.
    """
    T, K, C, R = fb_g.shape
    group_exit = ot_part <= 0.999
    # S[t, k, s, m] = fb_g[t, k, :, s] . anchors[t, :, m]  ('tcm,tkcs->tksm')
    S = torch.matmul(fb_g.transpose(-1, -2), anchors[:, None])
    if stream_dtype == "bfloat16":
        S = S.to(torch.bfloat16)
    elif stream_dtype != "float32":
        raise ValueError(f"unsupported stream_dtype {stream_dtype}")
    if cost is not None:
        cost = cost.to(S.dtype)
    u = u.float()
    v = v.float()
    kw = dict(iters=iters, thresh=thresh, ot_temp=ot_temp, ot_part=ot_part)
    if group_exit and K > PAIR_CHUNK:
        nch = -(-K // PAIR_CHUNK)
        wrap = torch.arange(nch * PAIR_CHUNK, device=S.device) % K
        KW = nch * PAIR_CHUNK
        pairs = lambda x: x[:, wrap].reshape(T * KW, *x.shape[2:]).contiguous()
        scores = sinkhorn_scores(
            pairs(S), pairs(u), pairs(v), group=PAIR_CHUNK,
            cost=None if cost is None else pairs(cost), **kw,
        )
        return scores.reshape(T, KW)[:, :K]
    pairs = lambda x: x.reshape(T * K, *x.shape[2:]).contiguous()
    scores = sinkhorn_scores(
        pairs(S), pairs(u), pairs(v), group=K if group_exit else 1,
        cost=None if cost is None else pairs(cost), **kw,
    )
    return scores.reshape(T, K)


def _rollout_tile(feature_bank, rollout, top_inds, idx, use_uniform, **kw):
    K = top_inds.shape[1]
    R = feature_bank.shape[2]
    inds = top_inds[idx]
    anchors = feature_bank[idx]
    fb_g = feature_bank[inds]  # (T, K, C, R)
    if use_uniform:
        u = torch.full((idx.shape[0], K, R), 1.0 / R, device=feature_bank.device)
        v = u
    else:
        u, v = rollout_marginals(rollout[idx], rollout[inds])
    return fused_rerank_tile(anchors, fb_g, u, v, **kw)


def fused_rollout_rerank_scores(
    feature_bank: torch.Tensor,
    rollout: torch.Tensor,
    top_inds: torch.Tensor,
    ot_temp: float = 0.05,
    iters: int = 100,
    thresh: float = 1e-1,
    query_tile: int = 128,
    use_uniform: bool = False,
    ot_part: float = 1.0,
    stream_dtype: str = "float32",
) -> torch.Tensor:
    """Flagship rollout rerank over all queries, tiled to bound the gather.

    feature_bank (N, C, R) normalized, rollout (N, R), top_inds (N, K).
    Returns (N, K) OT scores aligned with top_inds.  (The JAX function also
    takes the global embeddings, which the rollout marginals do not use.)
    """
    N = feature_bank.shape[0]
    feature_bank = feature_bank.float()
    out = []
    for start in range(0, N, query_tile):
        idx = torch.arange(start, min(start + query_tile, N), device=feature_bank.device)
        out.append(_rollout_tile(
            feature_bank, rollout, top_inds, idx, use_uniform,
            iters=iters, thresh=thresh, ot_temp=ot_temp, ot_part=ot_part,
            stream_dtype=stream_dtype,
        ))
    return torch.cat(out, dim=0)


def _featvit_tile(feature_bank, centers, top_inds, idx, use_uniform, use_inverse, use_minus,
                  use_soft, use_cls_token, temperature, **kw):
    """One query tile of the featvit method (rerank_pallas.py:723-766, the
    query == gallery case): cross-attention marginals from the patch-mean
    (or the global embedding, ``use_cls_token``) of each side."""
    inds = top_inds[idx]
    anchors = feature_bank[idx]  # (T, C, R)
    fb_g = feature_bank[inds]  # (T, K, C, R)
    if use_cls_token:
        ac, fbc = centers[idx], centers[inds]
    else:
        ac, fbc = anchors.mean(dim=-1), fb_g.mean(dim=-1)
    u, v, _ = cross_attention_marginals(
        anchors, l2_normalize(ac), fb_g, l2_normalize(fbc),
        use_uniform=use_uniform, use_inverse=use_inverse, use_minus=use_minus,
        use_soft=use_soft, temperature=temperature,
    )
    return fused_rerank_tile(anchors, fb_g, u, v, **kw)


def fused_featvit_rerank_scores(
    feature_bank: torch.Tensor,
    centers: torch.Tensor,
    top_inds: torch.Tensor,
    ot_temp: float = 0.05,
    iters: int = 100,
    thresh: float = 1e-1,
    query_tile: int = 128,
    use_uniform: bool = False,
    use_inverse: bool = False,
    use_minus: bool = False,
    use_soft: bool = False,
    use_cls_token: bool = False,
    temperature: float = 1.0,
    ot_part: float = 1.0,
    stream_dtype: str = "float32",
) -> torch.Tensor:
    """Fused rerank with cross-attention marginals (the calc_similarity
    stage-1 path, reference diml.py:77-147; rerank_pallas.py:549-594).

    feature_bank (N, C, R) normalized, centers (N, C), top_inds (N, K).
    Returns (N, K) OT scores aligned with top_inds.
    """
    N = feature_bank.shape[0]
    feature_bank, centers = feature_bank.float(), centers.float()
    out = []
    for start in range(0, N, query_tile):
        idx = torch.arange(start, min(start + query_tile, N), device=feature_bank.device)
        out.append(_featvit_tile(
            feature_bank, centers, top_inds, idx, use_uniform, use_inverse, use_minus,
            use_soft, use_cls_token, temperature, iters=iters, thresh=thresh,
            ot_temp=ot_temp, ot_part=ot_part, stream_dtype=stream_dtype,
        ))
    return torch.cat(out, dim=0)


def fused_qk_rerank_scores(
    feature_bank: torch.Tensor,
    q_bank: torch.Tensor,
    k_bank: torch.Tensor,
    top_inds: torch.Tensor,
    iters: int = 100,
    thresh: float = 1e-1,
    query_tile: int = 128,
    use_uniform: bool = False,
    use_exp: bool = False,
    temperature: float = 1.0,
    scale: float = 1.0 / 8.0,
    stream_dtype: str = "float32",
) -> torch.Tensor:
    """Fused rerank for the q/k-attention method (reference
    calc_similarity_vit/cvt, diml.py:206-320, full OT; rerank_pallas.py:
    597-668): the OT kernel comes from the pair's q.k attention map (K1's
    separate cost) while the score contracts against the feature similarity.

    q_bank/k_bank: (N, heads, T+1, D) raw projections of the probed block,
    with T = R tokens (the rerank grid must be the token grid).  The
    marginals are the cls row and column of the pair's attention map.
    Returns (N, K) OT scores aligned with top_inds.
    """
    N, C, R = feature_bank.shape
    if q_bank.shape[2] != R + 1 or k_bank.shape[2] != R + 1:
        raise ValueError(
            f"fused_qk_rerank_scores: {R} rerank patches need {R + 1} tokens (cls + one per "
            f"patch), got q {tuple(q_bank.shape)} k {tuple(k_bank.shape)}"
        )
    K = top_inds.shape[1]
    eps = 1e-5
    feature_bank = feature_bank.float()
    # per-image head mean and L2 norm, once; then the cls token and the
    # patch tokens apart, so each tile builds its cost contiguous
    q_mean = l2_normalize(q_bank.float().mean(dim=1))  # (N, R+1, D)
    k_mean = l2_normalize(k_bank.float().mean(dim=1))
    q_cls, q_patch = q_mean[:, 0], q_mean[:, 1:].contiguous()
    k_cls, k_patch = k_mean[:, 0], k_mean[:, 1:].contiguous()
    out = []
    for start in range(0, N, query_tile):
        idx = torch.arange(start, min(start + query_tile, N), device=feature_bank.device)
        inds = top_inds[idx]
        t = idx.shape[0]
        qp = q_patch[idx].transpose(1, 2)  # (t, D, R)
        kp = k_patch[inds]  # (t, K, R, D)
        # dp[t, k, s, m] = k_mean[gallery token s] . q_mean[anchor token m] * scale;
        # the patch block dp[:, :, 1:, 1:] is the OT cost
        cost = torch.matmul(kp.reshape(t, K * R, -1), qp).reshape(t, K, R, R).mul_(scale)
        if use_uniform:
            u = torch.full((t, K, R), 1.0 / R, device=feature_bank.device)
            v = u
        else:
            du = torch.matmul(kp, q_cls[idx][:, None, :, None])[..., 0] * scale  # dp[:, :, 1:, 0]
            dv = torch.matmul(k_cls[inds], qp) * scale  # dp[:, :, 0, 1:]
            if use_exp:
                u = torch.exp(-torch.relu(du) / temperature)
                v = torch.exp(-torch.relu(dv) / temperature)
            else:
                u, v = torch.relu(du), torch.relu(dv)
            u = u / (torch.sum(u, dim=-1, keepdim=True) + eps)
            v = v / (torch.sum(v, dim=-1, keepdim=True) + eps)
        out.append(fused_rerank_tile(
            feature_bank[idx], feature_bank[inds], u, v, iters=iters, thresh=thresh,
            ot_temp=0.05, ot_part=1.0, stream_dtype=stream_dtype, cost=cost,
        ))
    return torch.cat(out, dim=0)
