"""Retrieval metrics — Recall@1, R-Precision, MAP@R — batched on the device.

Port of vit_reranking_tpu/engine/metrics.py (reference evaluation/
metrics.py:3-47), including the convention that ``num_pos`` counts the query
itself (the self-match is pushed to the bottom of the ranking by the caller's
``sim[idx] = -100`` mask, reference evaluation/eval_cvt_diml.py:327).
"""

from __future__ import annotations

from typing import Dict

import torch


def metrics_from_ranks(
    final_tops: torch.Tensor,
    query_labels: torch.Tensor,
    gallery_labels: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Per-query metrics from ranked gallery indices.

    Args:
      final_tops: (Q, N) int — gallery indices in descending score order
        (reference `get_metrics_rank`, evaluation/metrics.py:26-47).
      query_labels: (Q,)
      gallery_labels: (N_gallery,)

    Returns per-query tensors `r1`, `rp`, `mapr`, each (Q,) float32.
    """
    N = final_tops.shape[1]
    g = gallery_labels[final_tops]  # (Q, N) labels in rank order
    eq = (g == query_labels[:, None]).float()

    r1 = eq[:, 0]
    # includes the query itself, like the reference
    num_pos = torch.sum((gallery_labels[None, :] == query_labels[:, None]).float(), dim=-1)
    ks = torch.arange(N, dtype=torch.float32, device=eq.device)
    kmask = (ks[None, :] < num_pos[:, None]).float()

    rp = torch.sum(eq * kmask, dim=-1) / num_pos
    precision_at_k = torch.cumsum(eq, dim=-1) * eq / (ks[None, :] + 1.0)
    mapr = torch.sum(precision_at_k * kmask, dim=-1) / num_pos
    return {"r1": r1, "rp": rp, "mapr": mapr}


def metrics_from_scores(
    sims: torch.Tensor,
    query_labels: torch.Tensor,
    gallery_labels: torch.Tensor,
    mask_diagonal: bool = True,
) -> Dict[str, torch.Tensor]:
    """Metrics straight from a (Q, N) score matrix (reference `get_metrics`).

    With ``mask_diagonal`` the self-similarity is set to -100 before ranking
    (queries assumed to be the gallery in the same order), matching
    train_baseline.py:275-278.  Ties rank the lower gallery index first, as
    the JAX package's stable argsort does.
    """
    if mask_diagonal:
        Q, N = sims.shape
        eye = torch.eye(N, dtype=torch.bool, device=sims.device)[:Q]
        sims = torch.where(eye, torch.full_like(sims, -100.0), sims)
    tops = torch.argsort(-sims, dim=-1, stable=True)
    return metrics_from_ranks(tops, query_labels, gallery_labels)


def summarize(per_query: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Dataset-level numbers in percent, matching the reference's
    division by N/100 (evaluation/eval_cvt_diml.py:402-405)."""
    return {k: float(torch.mean(v)) * 100.0 for k, v in per_query.items()}
