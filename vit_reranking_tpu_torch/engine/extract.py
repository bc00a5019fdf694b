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
(eval_cvt_diml.py:304-305).  In training mode (a DIML model's
evaluation, eval_cvt_diml.py:280-285) the bank is the model's per-patch
output and the center its ``enc_out``.  ``extract_features_device`` does
the same over a pool resident on the device
(data/device_cache.py::DeviceEvalCache):
``--cache_device``, no image crosses from the host; ``embed_split`` takes
whichever of the two a split has.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..data.device_cache import PixelNormalizer
from ..ops.pooling import grid_resize_tokens
from ..ops.rollout import rollout_saliency
from ..ops.similarity import l2_normalize


@torch.no_grad()
def embed_batch(model, images: torch.Tensor, grid_size: int = 7, use_rollout: bool = False,
                use_qk: bool = False, training_mode: bool = False) -> Dict[str, torch.Tensor]:
    """One batch (B, 3, H, W) -> {'bank' (B, D, grid^2), 'center' (B, D),
    'rollout' (B, grid^2)?, 'q'/'k' (B, heads, T+1, hd)?}, not yet
    normalized.  ``training_mode``: the model's first output is the
    per-patch map (B, g, g, D) (a DIML model), which becomes the bank (B,
    D, g^2) as it is, and its ``enc_out`` the center (JAX extract.py:48-53)."""
    out, (enc_out, no_avg_feat), aux = model(images, ret_attn=use_rollout or use_qk)
    if training_mode:
        B = out.shape[0]
        res = {"bank": out.reshape(B, -1, out.shape[-1]).transpose(1, 2), "center": enc_out}
    else:
        tokens = aux.get("head_tokens", no_avg_feat)
        B, L, D = tokens.shape
        s = int(round(L**0.5))
        if s * s != L:
            # the JAX package takes the same square side and fails there too
            raise ValueError(
                f"the patch bank needs a square token map: {L} tokens from a "
                f"{images.shape[2]}x{images.shape[3]} input are not a square grid "
                "(give a square input size)")
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
    training_mode: bool = False,
) -> Dict[str, torch.Tensor]:
    """Run ``model`` (in evaluation mode, on ``device``) over a loader of
    (labels, NHWC images, indices) batches; returns tensors on ``device``
    {'bank' (N,C,R), 'center' (N,C), 'labels' (N,), 'rollout' (N,R)?,
    'q'/'k' (N,heads,T+1,hd)?}, q and k in the model's compute dtype (bf16
    from a bf16 model, as the JAX package keeps them), the others f32.

    The outputs stay on ``device`` and are normalized there, so the rerank
    that follows reads them with no round trip through the host."""
    model.eval()
    parts: Dict[str, list] = {"bank": [], "center": [], "rollout": [], "q": [], "k": []}
    labels = []
    for lab, images, _ in loader:
        x = torch.from_numpy(np.ascontiguousarray(images)).to(device).permute(0, 3, 1, 2).contiguous()
        res = embed_batch(model, x, grid_size, use_rollout, use_qk, training_mode)
        for k, v in res.items():
            parts[k].append(v)
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


def extract_features_device(
    model,
    images: torch.Tensor,
    batch_size: int = 32,
    grid_size: int = 7,
    use_rollout: bool = False,
    use_qk: bool = False,
    uint8_input: bool = False,
    training_mode: bool = False,
) -> Dict[str, torch.Tensor]:
    """:func:`extract_features` over a pool resident on its device,
    (N, H, W, 3), uint8 pixels normalized a batch at a time
    (``uint8_input``) or final float values; returns tensors on the pool's
    device {'bank', 'center', 'rollout'?, 'q'?, 'k'?} (the caller has the
    labels).  The pool is embedded in whole batches gathered from it, the
    tail batch wrap-padded from the pool's start and cropped off the
    outputs, as the JAX package's extract_features_device.  The JAX package
    also cuts the pool into chunks by free memory, because XLA keeps a
    layout copy of the whole image operand inside its one compiled loop;
    here each batch is gathered on its own, so no chunk bounds memory."""
    model.eval()
    n = images.shape[0]
    rows = torch.arange(n + (-n) % batch_size, device=images.device) % n
    pixels = PixelNormalizer(images.device) if uint8_input else None
    parts: Dict[str, list] = {}
    for s in range(0, rows.numel(), batch_size):
        x = images.index_select(0, rows[s:s + batch_size]).permute(0, 3, 1, 2).float()
        if pixels is not None:
            x = pixels(x)
        res = embed_batch(model, x.contiguous(), grid_size, use_rollout, use_qk, training_mode)
        for k, v in res.items():
            parts.setdefault(k, []).append(v)
    out = {k: torch.cat(v)[:n] for k, v in parts.items()}
    out["bank"] = l2_normalize(out["bank"], dim=1)
    out["center"] = l2_normalize(out["center"], dim=1)
    return out


def embed_split(model, loader, pool=None, grid_size: int = 7, use_rollout: bool = False,
                use_qk: bool = False, device: str = "cuda",
                training_mode: bool = False) -> Dict[str, torch.Tensor]:
    """A split's features and labels, as :func:`extract_features` returns
    them: over the resident ``pool`` (data/device_cache.py::DeviceEvalCache,
    ``--cache_device``) in the loader's batch size when one is given, else
    over ``loader``."""
    if pool is None:
        return extract_features(model, loader, grid_size, use_rollout, device, use_qk,
                                training_mode)
    feats = extract_features_device(model, pool.images, loader.batch_size, grid_size,
                                    use_rollout, use_qk, uint8_input=not pool.normalized,
                                    training_mode=training_mode)
    feats["labels"] = pool.labels
    return feats
