"""Blocked pairwise similarity + streaming exact top-k.

Port of vit_reranking_tpu/ops/topk.py (the replacement for faiss
``IndexFlatL2/IP`` brute-force search, reference evaluation/__init__.py:86-88):
the gallery is scored in blocks and merged into a running top-k, so large
galleries never materialise a Q x N matrix.  Ties go to the lower gallery
index, as with ``jax.lax.top_k`` (a stable descending sort of the running
head followed by the block).  The approximate per-block mode waits for a
later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pairwise_topk(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    k: int,
    block_size: int = 8192,
    mask_self: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of a (Q, N) score matrix computed in gallery blocks.

    Args:
      queries: (Q, C); gallery: (N, C); scores are inner products (cosine
        on pre-normalized embeddings).
      mask_self: gallery index q scores -100 for query q (self-retrieval
        exclusion, eval_cvt_diml.py:327).
    Returns (values (Q, k), indices (Q, k) int64) sorted descending.
    """
    Q = queries.shape[0]
    N = gallery.shape[0]
    dev = queries.device
    vals = torch.full((Q, 0), float("-inf"), device=dev)
    inds = torch.zeros((Q, 0), dtype=torch.int64, device=dev)
    qids = torch.arange(Q, device=dev)
    for start in range(0, N, block_size):
        blk = gallery[start:start + block_size]
        s = torch.matmul(queries.float(), blk.float().T)
        gidx = torch.arange(start, start + blk.shape[0], device=dev)
        if mask_self:
            s = torch.where(gidx[None, :] == qids[:, None], torch.full_like(s, -100.0), s)
        cat_vals = torch.cat([vals, s], dim=1)
        cat_inds = torch.cat([inds, gidx[None, :].expand(Q, -1)], dim=1)
        order = torch.sort(cat_vals, dim=1, descending=True, stable=True).indices[:, :k]
        vals = torch.gather(cat_vals, 1, order)
        inds = torch.gather(cat_inds, 1, order)
    return vals, inds


def similarity_matrix(
    queries: torch.Tensor, gallery: torch.Tensor, mask_self: bool = False
) -> torch.Tensor:
    """Full (Q, N) cosine/IP score matrix with optional self-masking (-100)."""
    s = torch.matmul(queries.float(), gallery.float().T)
    if mask_self:
        Q, N = s.shape
        eye = torch.eye(N, dtype=torch.bool, device=s.device)[:Q]
        s = torch.where(eye, torch.full_like(s, -100.0), s)
    return s
