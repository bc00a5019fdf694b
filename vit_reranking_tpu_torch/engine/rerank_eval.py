"""The rerank evaluation engine — stage-0 retrieval + OT rerank + metrics.

Port of vit_reranking_tpu/engine/rerank_eval.py (reference evaluation/
eval_cvt_diml.py:196-416) for the rollout method: blocked exact top-K over
the global embeddings, the Sinkhorn rerank of each query against its K
candidates, the ``ot_sim + global_sim`` splice and R@1 / RP / MAP@R.

Metrics only inspect the first ``num_pos <= Kmax`` ranked entries, so each
query keeps a top-``Kmax`` head where ``Kmax >= max(trunc_nums, max class
size)``, the reranked top-``trunc`` is spliced into it, and the metrics come
from the head alone.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import torch

from ..ops.rerank import PAIR_CHUNK, fused_rollout_rerank_scores
from ..ops.similarity import calc_similarity_rollout
from ..ops.topk import pairwise_topk
from .metrics import metrics_from_ranks

log = logging.getLogger(__name__)

# queries per rerank tile: bounds the (tile, K, C, R) candidate gather
QUERY_BLOCK = 128


def rerank_evaluate(
    feature_bank: torch.Tensor,
    feature_bank_center: torch.Tensor,
    labels: torch.Tensor,
    rollout: Optional[torch.Tensor] = None,
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
      rollout: (N, R) rollout saliency.
      trunc_nums: 0 = global-only; k = OT-rerank top-k then splice
        (reference eval_cvt_diml.py:359-365).
      use_fused: None = the fused kernel path when ``flags["use_ot"]``
        (default True), else the eager Sinkhorn, as in the JAX package.
      stream_dtype: "bfloat16" rounds the fused path's similarity tensor to
        bf16 (Sinkhorn math stays f32); ignored on the eager path.
    """
    if method != "rollout":
        raise NotImplementedError(f"rerank method {method!r} is not ported yet")
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
        if ot_part <= 0.999 and K > PAIR_CHUNK and use_fused is None and \
                flags.get("use_ot", True):
            log.warning(
                "partial OT with trunc %d > %d: the fused kernel's exit residual is "
                "per %d-pair chunk (the reference uses the full-K batch mean); pass "
                "use_fused=False for the eager path", K, PAIR_CHUNK, PAIR_CHUNK,
            )
        if use_fused is None:
            use_fused = flags.get("use_ot", True)
        if use_fused:
            ot_sims = fused_rollout_rerank_scores(
                feature_bank, rollout, top_inds, query_tile=QUERY_BLOCK,
                use_uniform=use_uniform, ot_part=ot_part, stream_dtype=stream_dtype,
            )
        else:
            tiles = []
            for start in range(0, N, QUERY_BLOCK):
                idx = torch.arange(start, min(start + QUERY_BLOCK, N), device=feature_bank.device)
                inds = top_inds[idx]
                sim, _ = calc_similarity_rollout(
                    feature_bank_center[idx], feature_bank[idx], rollout[idx],
                    feature_bank_center[inds], feature_bank[inds], rollout[inds],
                    stage=1, use_uniform=use_uniform, ot_part=ot_part,
                )
                tiles.append(sim)
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
