"""Feature-bank extraction: embed a whole dataset batch by batch.

Port of vit_reranking_tpu/engine/extract.py::extract_features (reference
eval_cvt_diml.py:225-305): run the model over the eval loader, collect
  * global embedding centers (N, C)
  * patch feature bank (N, C, R) — head-projected token maps pooled to the
    DIML grid (eval_cvt_diml.py:265-276)
  * rollout saliency (N, R) when requested
then L2-normalize over the channel axis (eval_cvt_diml.py:304-305).  The
device-resident whole-dataset variant waits for a later slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.pooling import grid_resize_tokens
from ..ops.rollout import rollout_saliency
from ..ops.similarity import l2_normalize


@torch.no_grad()
def embed_batch(model, images: torch.Tensor, grid_size: int = 7,
                use_rollout: bool = False) -> Dict[str, torch.Tensor]:
    """One batch (B, 3, H, W) -> {'bank' (B, D, grid^2), 'center' (B, D),
    'rollout' (B, grid^2)?}, not yet normalized."""
    out, (_, no_avg_feat), aux = model(images, ret_attn=use_rollout)
    tokens = aux.get("head_tokens", no_avg_feat)
    B, L, D = tokens.shape
    s = int(round(L**0.5))
    fmap = grid_resize_tokens(tokens.transpose(1, 2).reshape(B, D, s, s), grid_size)
    res = {"bank": fmap.reshape(B, D, grid_size * grid_size), "center": out}
    if use_rollout:
        res["rollout"] = rollout_saliency(aux["rollout_maps"])
    return res


def extract_features(
    model,
    loader,
    grid_size: int = 7,
    use_rollout: bool = False,
    device: str = "cuda",
) -> Dict[str, torch.Tensor]:
    """Run ``model`` (in evaluation mode, on ``device``) over a loader of
    (labels, NHWC images, indices) batches; returns tensors on ``device``
    {'bank' (N,C,R), 'center' (N,C), 'labels' (N,), 'rollout' (N,R)?}.

    The outputs stay on ``device`` and are normalized there, so the rerank
    that follows reads them with no round trip through the host."""
    model.eval()
    parts: Dict[str, list] = {"bank": [], "center": [], "rollout": []}
    labels = []
    for lab, images, _ in loader:
        x = torch.from_numpy(np.ascontiguousarray(images)).to(device).permute(0, 3, 1, 2).contiguous()
        res = embed_batch(model, x, grid_size, use_rollout)
        for k, v in res.items():
            parts[k].append(v.float())
        labels.append(np.asarray(lab))
    out = {
        "bank": l2_normalize(torch.cat(parts["bank"]), dim=1),
        "center": l2_normalize(torch.cat(parts["center"]), dim=1),
        "labels": torch.from_numpy(np.concatenate(labels, 0)).to(device),
    }
    if use_rollout:
        out["rollout"] = torch.cat(parts["rollout"])
    return out
