"""Feature-bank extraction: embed a whole dataset batch by batch.

Port of vit_reranking_tpu/engine/extract.py::extract_features (reference
eval_cvt_diml.py:225-305): run the model over the eval loader, collect
  * global embedding centers (N, C)
  * patch feature bank (N, C, R) — head-projected token maps pooled to the
    DIML grid (eval_cvt_diml.py:265-276)
  * rollout saliency (N, R) when requested
  * the q/k projections (N, heads, T+1, hd) of the ViT's probed block for
    the qk method (eval_attn_diml.py:18-38)
then L2-normalize the bank and centers over the channel axis
(eval_cvt_diml.py:304-305).  The device-resident whole-dataset variant
waits for a later slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.pooling import grid_resize_tokens
from ..ops.rollout import rollout_saliency
from ..ops.similarity import l2_normalize


@torch.no_grad()
def embed_batch(model, images: torch.Tensor, grid_size: int = 7, use_rollout: bool = False,
                use_qk: bool = False) -> Dict[str, torch.Tensor]:
    """One batch (B, 3, H, W) -> {'bank' (B, D, grid^2), 'center' (B, D),
    'rollout' (B, grid^2)?, 'q'/'k' (B, heads, T+1, hd)?}, not yet
    normalized."""
    out, (_, no_avg_feat), aux = model(images, ret_attn=use_rollout or use_qk)
    tokens = aux.get("head_tokens", no_avg_feat)
    B, L, D = tokens.shape
    s = int(round(L**0.5))
    fmap = grid_resize_tokens(tokens.transpose(1, 2).reshape(B, D, s, s), grid_size)
    res = {"bank": fmap.reshape(B, D, grid_size * grid_size), "center": out}
    if use_rollout:
        res["rollout"] = rollout_saliency(aux["rollout_maps"])
    if use_qk:
        res["q"], res["k"] = aux["q"], aux["k"]
    return res


def extract_features(
    model,
    loader,
    grid_size: int = 7,
    use_rollout: bool = False,
    device: str = "cuda",
    use_qk: bool = False,
) -> Dict[str, torch.Tensor]:
    """Run ``model`` (in evaluation mode, on ``device``) over a loader of
    (labels, NHWC images, indices) batches; returns tensors on ``device``
    {'bank' (N,C,R), 'center' (N,C), 'labels' (N,), 'rollout' (N,R)?,
    'q'/'k' (N,heads,T+1,hd)?}.

    The outputs stay on ``device`` and are normalized there, so the rerank
    that follows reads them with no round trip through the host."""
    model.eval()
    parts: Dict[str, list] = {"bank": [], "center": [], "rollout": [], "q": [], "k": []}
    labels = []
    for lab, images, _ in loader:
        x = torch.from_numpy(np.ascontiguousarray(images)).to(device).permute(0, 3, 1, 2).contiguous()
        res = embed_batch(model, x, grid_size, use_rollout, use_qk)
        for k, v in res.items():
            parts[k].append(v.float())
        labels.append(np.asarray(lab))
    out = {
        "bank": l2_normalize(torch.cat(parts["bank"]), dim=1),
        "center": l2_normalize(torch.cat(parts["center"]), dim=1),
        "labels": torch.from_numpy(np.concatenate(labels, 0)).to(device),
    }
    for name in ("rollout", "q", "k"):
        if parts[name]:
            out[name] = torch.cat(parts[name])
    return out
