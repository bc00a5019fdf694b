"""The rerank evaluation engine — stage-0 retrieval + OT rerank + metrics.

Port of vit_reranking_tpu/engine/rerank_eval.py (reference evaluation/
eval_cvt_diml.py:196-416) for the rollout, featvit and qk methods: blocked
exact top-K over the global embeddings, the Sinkhorn rerank of each query
against its K candidates (fused through kernel K1, or eager), the
``ot_sim + global_sim`` splice and R@1 / RP / MAP@R.

Metrics only inspect the first ``num_pos <= Kmax`` ranked entries, so each
query keeps a top-``Kmax`` head where ``Kmax >= max(trunc_nums, max class
size)``, the reranked top-``trunc`` is spliced into it, and the metrics come
from the head alone.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import torch

from ..ops.rerank import (
    PAIR_CHUNK,
    fused_featvit_rerank_scores,
    fused_qk_rerank_scores,
    fused_rollout_rerank_scores,
)
from ..ops.similarity import calc_similarity, calc_similarity_qk, calc_similarity_rollout
from ..ops.topk import pairwise_topk
from .metrics import metrics_from_ranks

log = logging.getLogger(__name__)

# queries per rerank tile: bounds the (tile, K, C, R) candidate gather
QUERY_BLOCK = 128
METHODS = ("rollout", "featvit", "qk")


def _rerank_tile(anchor, anchor_center, anchor_aux, fb, fb_center, fb_aux, method, flags):
    """The eager OT rerank of a tile of queries (leading axis) against their
    top-K candidates (rerank_eval.py:39-136).  For method 'qk' the aux slots
    carry the q/k projections: anchor_aux = q (T, heads, T+1, D), fb_aux =
    k (T, K, heads, T+1, D)."""
    if method == "qk":
        sim, _ = calc_similarity_qk(
            anchor_center, anchor, anchor_aux, fb_center, fb, fb_aux, stage=1,
            use_uniform=flags.get("use_uniform", False),
            use_exp=flags.get("use_inverse", False),
            temperature=flags.get("temperature", 1.0),
            scale=flags.get("qk_scale", 1.0 / 8.0),
            use_ot=flags.get("use_ot", True),
        )
    elif method == "rollout":
        sim, _ = calc_similarity_rollout(
            anchor_center, anchor, anchor_aux, fb_center, fb, fb_aux, stage=1,
            use_uniform=flags.get("use_uniform", False),
            ot_part=flags.get("ot_part", 1.0),
        )
    else:  # 'featvit' — the calc_similarity cross-attention path
        sim, _ = calc_similarity(
            anchor, anchor_center, fb, fb_center, stage=1,
            use_uniform=flags.get("use_uniform", False),
            use_inverse=flags.get("use_inverse", False),
            temperature=flags.get("temperature", 1.0),
            use_cls_token=flags.get("use_cls_token", False),
            ot_temp=flags.get("ot_temp", 0.05),
            use_minus=flags.get("use_minus", False),
            use_soft=flags.get("use_soft", False),
            ot_part=flags.get("ot_part", 1.0),
        )
    return sim


def rerank_evaluate(
    feature_bank: torch.Tensor,
    feature_bank_center: torch.Tensor,
    labels: torch.Tensor,
    rollout: Optional[torch.Tensor] = None,
    rollout_g: Optional[torch.Tensor] = None,
    trunc_nums: Sequence[int] = (0, 100),
    method: str = "rollout",
    flags: Optional[dict] = None,
    use_fused: Optional[bool] = None,
    approx_topk: bool = False,
    stream_dtype: str = "float32",
) -> Dict[str, Dict[int, float]]:
    """Full evaluation: returns {'r1'|'rp'|'mapr': {trunc: percent}}.

    Args:
      feature_bank: (N, C, R) patch features, normalized over C
        (reference eval_cvt_diml.py:304).
      feature_bank_center: (N, C) global embeddings, normalized.
      labels: (N,) int labels; queries == gallery with self-masking.
      rollout: (N, R) rollout saliency for method 'rollout'; for 'qk' the
        q projections (N, heads, T+1, D) of the probed block.
      rollout_g: for 'qk', the k projections (N, heads, T+1, D); without
        them the eager path reads ``rollout`` on the gallery side too.
      trunc_nums: 0 = global-only; k = OT-rerank top-k then splice
        (reference eval_cvt_diml.py:359-365).
      method: 'rollout', 'featvit' (cross-attention marginals) or 'qk'.
      use_fused: None = the JAX package's rule: the fused kernel path when
        ``flags["use_ot"]`` (default True), for 'qk' only with both q and k
        banks; else the eager Sinkhorn.
      stream_dtype: "bfloat16" rounds the fused path's similarity tensor (and
        the qk cost) to bf16 (Sinkhorn math stays f32); ignored on the eager
        path.
    """
    if method not in METHODS:
        raise NotImplementedError(
            f"rerank method {method!r} is not ported yet (cam, mhvit and dist are queued "
            "in ROADMAP.md, Queue 1)"
        )
    if approx_topk:
        raise NotImplementedError("approximate stage-0 top-k is not ported yet")
    flags = dict(flags or {})
    N = feature_bank.shape[0]
    labels = torch.as_tensor(labels, device=feature_bank.device)

    # head must cover the largest class (metrics look at the first num_pos)
    # and the largest requested truncation
    max_pos = int(torch.unique(labels, return_counts=True)[1].max())
    K = int(max(trunc_nums))
    Kmax = max(min(N, max(max_pos, K, 1) + 1), K)
    vals, tops = pairwise_topk(feature_bank_center, feature_bank_center, k=Kmax, mask_self=True)

    results = {m: {} for m in ("r1", "rp", "mapr")}
    if K > 0:
        top_inds = tops[:, :K]
        top_vals = vals[:, :K]
        ot_part = float(flags.get("ot_part", 1.0))
        use_uniform = flags.get("use_uniform", False)
        use_ot = flags.get("use_ot", True)
        if ot_part <= 0.999 and K > PAIR_CHUNK and use_fused is None and use_ot and \
                method in ("rollout", "featvit"):
            log.warning(
                "partial OT with trunc %d > %d: the fused kernel's exit residual is "
                "per %d-pair chunk (the reference uses the full-K batch mean); pass "
                "use_fused=False for the eager path", K, PAIR_CHUNK, PAIR_CHUNK,
            )
        if use_fused is None:
            # qk is full-OT only and needs both the q and the k bank
            use_fused = use_ot and (
                method != "qk" or (rollout is not None and rollout_g is not None))
        if use_fused and method == "qk":
            ot_sims = fused_qk_rerank_scores(
                feature_bank, rollout, rollout_g, top_inds, query_tile=QUERY_BLOCK,
                use_uniform=use_uniform, use_exp=flags.get("use_inverse", False),
                temperature=flags.get("temperature", 1.0),
                scale=flags.get("qk_scale", 1.0 / 8.0), stream_dtype=stream_dtype,
            )
        elif use_fused and method == "rollout":
            ot_sims = fused_rollout_rerank_scores(
                feature_bank, rollout, top_inds, query_tile=QUERY_BLOCK,
                use_uniform=use_uniform, ot_part=ot_part, stream_dtype=stream_dtype,
            )
        elif use_fused:
            ot_sims = fused_featvit_rerank_scores(
                feature_bank, feature_bank_center, top_inds, query_tile=QUERY_BLOCK,
                use_uniform=use_uniform, use_inverse=flags.get("use_inverse", False),
                use_minus=flags.get("use_minus", False), use_soft=flags.get("use_soft", False),
                use_cls_token=flags.get("use_cls_token", False),
                temperature=flags.get("temperature", 1.0), ot_part=ot_part,
                stream_dtype=stream_dtype,
            )
        else:
            # anchor-side aux bank (rollout saliency, or the q projections);
            # the gallery side reads the k projections for 'qk' when given
            gal = rollout_g if rollout_g is not None else rollout
            tiles = []
            for start in range(0, N, QUERY_BLOCK):
                idx = torch.arange(start, min(start + QUERY_BLOCK, N), device=feature_bank.device)
                inds = top_inds[idx]
                tiles.append(_rerank_tile(
                    feature_bank[idx], feature_bank_center[idx],
                    None if rollout is None else rollout[idx],
                    feature_bank[inds], feature_bank_center[inds],
                    None if gal is None else gal[inds], method, flags,
                ))
            ot_sims = torch.cat(tiles, dim=0)
        # rerank within the head by ot_sim + global sim (eval_cvt_diml.py:357)
        order = torch.argsort(-(ot_sims + top_vals), dim=1, stable=True)
        reranked = torch.gather(top_inds, 1, order)

    for trunc in trunc_nums:
        final = tops if trunc == 0 else torch.cat([reranked[:, :trunc], tops[:, trunc:]], dim=1)
        per_q = metrics_from_ranks(final, labels, labels)
        for m in results:
            results[m][trunc] = float(torch.mean(per_q[m])) * 100.0
    return results
