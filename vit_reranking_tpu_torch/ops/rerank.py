"""Fused Sinkhorn rerank of each query against its top-K candidates.

Port of the rollout path of vit_reranking_tpu/ops/rerank_pallas.py.  The
patch similarity S of every (query, candidate) pair is one large product
outside the kernel (as the JAX package leaves it to XLA); kernel K1
(``csrc/sinkhorn_score.cu``, replacing the TPU kernel
``_sinkhorn_score_kernel``, rerank_pallas.py:97-234) then runs the whole
Sinkhorn loop and the final ``sum(T * S)`` per pair, reading S once.

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
from typing import Tuple

import torch
import torch.nn.functional as F

from . import native
from .sinkhorn import extend_dustbin

# pairs per exit group for K > PAIR_CHUNK under group exit (the TPU kernel's
# lane count, rerank_pallas.py:38, kept for its exit rule)
PAIR_CHUNK = 128


def _ot_inputs(S, u, v, ot_temp, ot_part):
    """f32 kernel matrix, similarity and marginals, extended by the dustbin
    row/column under partial OT (S is 0 there)."""
    S = S.float()
    Km = torch.exp(-(1.0 - S) / ot_temp)
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
):
    """``sum(T * S)`` per pair.

    Args:
      S: (P, R, R) patch similarity, rows = candidate patches, columns =
        query patches; f32 or bf16 (the loop math is f32 either way).
      u, v: (P, R) marginals over rows / columns.
      group: pairs ``[g*group, (g+1)*group)`` share one exit decision (their
        batch-mean residual); 1 = each pair exits on its own.
      return_iters: also return the scaling iterations each pair ran.
    Returns: (P,) f32 scores.
    """
    Km, S, u, v = _ot_inputs(S, u, v, ot_temp, ot_part)
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


def sinkhorn_scores(
    S: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    iters: int = 100,
    thresh: float = 1e-1,
    ot_temp: float = 0.05,
    ot_part: float = 1.0,
    group: int = 1,
) -> torch.Tensor:
    """:func:`sinkhorn_scores_plain`, as CUDA kernel K1 for CUDA tensors.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (``sinkhorn_scores.launches`` counts the launches).
    """
    if S.device.type == "cpu":
        return sinkhorn_scores_plain(S, u, v, iters, thresh, ot_temp, ot_part, group)
    if S.device.type != "cuda":
        raise ValueError(f"sinkhorn_scores: unsupported device {S.device}")
    P, R, R2 = S.shape
    if R2 != R or S.dtype not in (torch.float32, torch.bfloat16) or not S.is_contiguous():
        raise ValueError(
            f"sinkhorn_scores: S must be a contiguous (P, R, R) f32/bf16 tensor, "
            f"got {tuple(S.shape)} {S.dtype}"
        )
    for name, t in (("u", u), ("v", v)):
        if t.shape != (P, R) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != S.device:
            raise ValueError(f"sinkhorn_scores: {name} must be contiguous f32 (P, R) on {S.device}")
    if group < 1 or P % group:
        raise ValueError(f"sinkhorn_scores: {P} pairs do not split into groups of {group}")
    partial = ot_part <= 0.999
    RP = R + int(partial)
    out = torch.empty(P, dtype=torch.float32, device=S.device)
    # Km and its transpose per pair, row stride RP | 1, when a block walks a
    # whole group (they do not fit shared memory); unused for group == 1
    scratch = torch.empty(
        P * 2 * RP * (RP | 1) if group > 1 else 0, dtype=torch.float32, device=S.device
    )
    fn = native.launcher("sinkhorn_score", "sinkhorn_score_launch", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ])
    stream = torch.cuda.current_stream(S.device).cuda_stream
    native.check(
        fn(S.data_ptr(), int(S.dtype == torch.bfloat16), u.data_ptr(), v.data_ptr(),
           out.data_ptr(), scratch.data_ptr() if group > 1 else None, P, R, int(partial),
           1.0 - ot_part, ot_temp, iters, thresh, group, stream),
        "sinkhorn_scores",
    )
    sinkhorn_scores.launches += 1
    return out


sinkhorn_scores.launches = 0


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
) -> torch.Tensor:
    """One query tile: anchors (T, C, R), fb_g (T, K, C, R), u/v (T, K, R).
    Returns (T, K) scores.

    ``stream_dtype="bfloat16"`` rounds S to bf16 before the kernel reads it
    (half the kernel's input bytes; the loop math stays f32).
    Partial OT makes one query's candidates exit together on their
    batch-mean residual; for K > PAIR_CHUNK the rule is per wrap-padded
    PAIR_CHUNK-pair chunk, as in the JAX package.
    """
    T, K, C, R = fb_g.shape
    group_exit = ot_part <= 0.999
    # S[t, k, s, m] = fb_g[t, k, :, s] . anchors[t, :, m]  ('tcm,tkcs->tksm')
    S = torch.matmul(fb_g.transpose(-1, -2), anchors[:, None])
    if stream_dtype == "bfloat16":
        S = S.to(torch.bfloat16)
    elif stream_dtype != "float32":
        raise ValueError(f"unsupported stream_dtype {stream_dtype}")
    u = u.float()
    v = v.float()
    kw = dict(iters=iters, thresh=thresh, ot_temp=ot_temp, ot_part=ot_part)
    if group_exit and K > PAIR_CHUNK:
        nch = -(-K // PAIR_CHUNK)
        wrap = torch.arange(nch * PAIR_CHUNK, device=S.device) % K
        KW = nch * PAIR_CHUNK
        scores = sinkhorn_scores(
            S[:, wrap].reshape(T * KW, R, R).contiguous(),
            u[:, wrap].reshape(T * KW, R).contiguous(),
            v[:, wrap].reshape(T * KW, R).contiguous(),
            group=PAIR_CHUNK, **kw,
        )
        return scores.reshape(T, KW)[:, :K]
    scores = sinkhorn_scores(
        S.reshape(T * K, R, R).contiguous(),
        u.reshape(T * K, R).contiguous(),
        v.reshape(T * K, R).contiguous(),
        group=K if group_exit else 1, **kw,
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
