"""MSLS validation: per-city global retrieval, the optional DIML rerank of
the top candidates, and Recall@N against the UTM ground truth (reference
training_tools/val.py:68-252).

Port of vit_reranking_tpu/engine/msls_val.py.  The queries and the database
are different banks, so the rerank is the query != gallery featvit form,
kernel K1 on the card (ops/rerank.py::fused_featvit_rerank_scores_qg).  The
global product is f32 (TF32 off) and every ranking is a stable argsort, as
``jnp.argsort`` is: near-ties order by index.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.rerank import PAIR_CHUNK, check_cls_widths, fused_featvit_rerank_scores_qg
from ..ops.similarity import calc_similarity, l2_normalize

# frame batches whose images are loaded on the host at once
_CHUNK_BATCHES = 32


def _aggregate(frame_embs: torch.Tensor, L: int, eps: float = 1e-12) -> torch.Tensor:
    """(B*L, D) frame embeddings -> (B, D) L2-normalised means
    (data/msls.py::MSLS.aggregate_seq on tensors)."""
    e = frame_embs.reshape(-1, L, frame_embs.shape[-1]).mean(1)
    return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + eps)


def _embed_names(eval_set, names, extract_fn: Callable, batch: int = 16):
    """Load keys through the dataset and embed them in fixed ``batch``-frame
    forwards.  ``extract_fn(images (B, H, W, 3) float32 numpy) -> (centers
    (B, D), dense (B, C, R) or None)``, tensors or arrays.

    Sequence keys (comma-joined frames) load as (L, H, W, 3) stacks: the
    global descriptor is the L2-normalised mean of the frames' embeddings
    and the dense rerank features are the center frame's.  Returns
    (centers, dense or None) as tensors where ``extract_fn`` put them."""
    if not len(names):
        return torch.zeros((0, 1)), None
    first = eval_set.load_image_array(names[0])
    seq = first.ndim == 4
    L = first.shape[0] if seq else 1
    keys_per_chunk = max(_CHUNK_BATCHES * batch // L, 1)

    c_parts, d_parts = [], []
    for s in range(0, len(names), keys_per_chunk):
        arr = np.stack([eval_set.load_image_array(n) for n in names[s : s + keys_per_chunk]])
        flat = arr.reshape(-1, *arr.shape[-3:])
        m = flat.shape[0]
        if m % batch:
            flat = np.concatenate(
                [flat, np.zeros((batch - m % batch, *flat.shape[1:]), flat.dtype)])
        for b in range(0, m, batch):
            c, d = extract_fn(flat[b : b + batch])
            n = min(batch, m - b)
            c_parts.append(torch.as_tensor(c)[:n])
            if d is not None:
                d_parts.append(torch.as_tensor(d)[:n])
    c = torch.cat(c_parts)
    d = torch.cat(d_parts) if d_parts else None
    if not seq:
        return c, d
    dense = None if d is None else d.reshape(len(names), L, *d.shape[1:])[:, L // 2]
    return _aggregate(c, L), dense


def recall_at_n(pred_list, gt, n_values, n_queries) -> np.ndarray:
    """Recall@N against the UTM ground truth (reference val.py:211-251):
    ``pred_list`` holds one (nq_city, kk) index array per city, ``gt`` the
    concatenated per-query positive lists (ragged).  A query counts at N
    when one of its first min(N, kk) predictions is a positive."""
    correct = np.zeros(len(n_values))
    qix = 0
    for city_preds in pred_list:
        city_preds = np.asarray(city_preds)
        nq, kk = city_preds.shape
        g = gt[qix : qix + nq]
        gmax = max((len(x) for x in g), default=0)
        gtpad = np.full((nq, max(gmax, 1)), -1, np.int64)
        for i, x in enumerate(g):
            gtpad[i, : len(x)] = x
        hits = np.any(city_preds[:, :, None] == gtpad[:, None, :], axis=-1)  # (nq, kk)
        hit_by_rank = np.cumsum(hits, axis=1) > 0
        cols = [min(n, kk) - 1 for n in n_values]
        correct += np.sum(hit_by_rank[:, cols], axis=0)
        qix += nq
    return correct / max(n_queries, 1)


def _stable_order(scores: torch.Tensor) -> torch.Tensor:
    return torch.argsort(-scores, dim=1, stable=True)


def msls_val(
    eval_set,
    extract_fn: Callable,
    trunc_nums: Sequence[int] = (0, 100),
    n_values: Sequence[int] = (1, 5, 10, 20, 50, 100),
    batch: int = 16,
    rerank_flags: Optional[dict] = None,
    visual_dir: Optional[str] = None,
    details: Optional[dict] = None,
) -> Dict[str, float]:
    """Returns {'globalR_N': ..., 'dimlR_N': ...} recalls.

    ``rerank_flags`` default to the reference's validation settings
    (val.py:177-187): use_minus, use_cls_token, temperature 0.1, full OT.
    The rerank takes the K = max(trunc_nums) best global candidates of each
    query (at most the city's database) and orders them by OT score plus
    global similarity; without a dense bank (``extract_fn`` returns None)
    only the global recalls are computed.  ``details``, when given, gets
    each city's global order ``preds`` and final order ``final`` (tensors),
    and the ``features`` ranked: (query embeddings, query banks, database
    embeddings, database banks), the banks normalized (None without).
    ``visual_dir`` (the reference's OT heatmaps) raises
    ``NotImplementedError``: utils/visual.py's heatmaps are not ported."""
    if visual_dir:
        raise NotImplementedError("msls_val visual_dir: the OT heatmaps are not ported yet")
    flags = dict(
        use_uniform=False, use_inverse=False, temperature=0.1,
        use_cls_token=True, ot_temp=0.05, use_minus=True, ot_part=1.0,
    )
    flags.update(rerank_flags or {})
    trunc_nums = list(trunc_nums)
    K = max(trunc_nums)
    n_values = list(n_values)
    nmax = max(n_values)

    qFeat, qDense = _embed_names(eval_set, list(eval_set.qImages), extract_fn, batch)
    dbFeat, dbDense = _embed_names(eval_set, list(eval_set.dbImages), extract_fn, batch)
    if qDense is None or dbDense is None:
        K = 0
    else:
        qDense = l2_normalize(qDense.float(), dim=1)
        dbDense = l2_normalize(dbDense.float(), dim=1)
        if K > 0 and flags.get("use_cls_token", True):
            check_cls_widths(qFeat, qDense)
    qFeat, dbFeat = qFeat.float(), dbFeat.float()

    gt = eval_set.all_pos_indices
    predictions, final_preds = [], []
    if details is not None:
        details.update(preds=[], final=[], features=(qFeat, qDense, dbFeat, dbDense))
    qTot = dbTot = 0
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for qEnd, dbEnd in zip(eval_set.qEndPosList, eval_set.dbEndPosList):
            qF = qFeat[qTot : qTot + qEnd]
            dbF = dbFeat[dbTot : dbTot + dbEnd]
            sim = qF @ dbF.T
            kk = min(max(nmax, K), dbEnd)
            preds = _stable_order(sim)[:, :kk]
            if K > 0 and qEnd == 0:
                final_preds.append(preds.cpu().numpy())
            elif K > 0:
                qD = qDense[qTot : qTot + qEnd]
                dbD = dbDense[dbTot : dbTot + dbEnd]
                Keff = min(K, dbEnd)
                top = preds[:, :Keff]
                use_fused = flags.get("use_ot", True) and (
                    flags.get("ot_part", 1.0) > 0.999 or Keff <= PAIR_CHUNK)
                if use_fused:
                    ot = fused_featvit_rerank_scores_qg(
                        qD, qF, dbD, dbF, top,
                        query_tile=min(256, int(qEnd)),
                        use_uniform=flags.get("use_uniform", False),
                        use_inverse=flags.get("use_inverse", False),
                        use_minus=flags.get("use_minus", False),
                        use_soft=flags.get("use_soft", False),
                        use_cls_token=flags.get("use_cls_token", True),
                        temperature=flags.get("temperature", 1.0),
                        ot_temp=flags.get("ot_temp", 0.05),
                        ot_part=flags.get("ot_part", 1.0),
                    )
                else:
                    ot = eager_rerank_scores(qD, qF, dbD, dbF, top, flags)
                adj = ot + torch.gather(sim, 1, top)
                order = _stable_order(adj)
                rerank = torch.gather(top, 1, order)
                final = torch.cat([rerank, preds[:, Keff:]], dim=1)
                final_preds.append(final.cpu().numpy())
                if details is not None:
                    details["final"].append(final)
            if details is not None:
                details["preds"].append(preds)
            predictions.append(preds.cpu().numpy())
            qTot += qEnd
            dbTot += dbEnd
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev

    n_queries = len(eval_set.qIdx)
    out = {}
    g = recall_at_n(predictions, gt, n_values, n_queries)
    for i, n in enumerate(n_values):
        out[f"globalR_{n}"] = float(g[i])
    if final_preds:
        f = recall_at_n(final_preds, gt, n_values, n_queries)
        for i, n in enumerate(n_values):
            out[f"dimlR_{n}"] = float(f[i])
    return out


def eager_rerank_scores(qD, qF, dbD, dbF, top, flags: dict,
                        query_tile: int = 256) -> torch.Tensor:
    """The stage-1 ``calc_similarity`` score of each query against its
    candidates ``top`` (the JAX package's vmapped eager branch: each
    query's candidates share one Sinkhorn exit), tiled over queries to
    bound the gathered candidates."""
    kw = {k: v for k, v in flags.items() if k != "use_ot"}
    out = []
    for s in range(0, top.shape[0], query_tile):
        t = top[s : s + query_tile]
        score, _ = calc_similarity(qD[s : s + query_tile], qF[s : s + query_tile], dbD[t],
                                   dbF[t], stage=1, **kw)
        out.append(score)
    return torch.cat(out, dim=0)
