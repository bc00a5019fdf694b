"""Model registry — substring dispatch over the arch string.

Port of vit_reranking_tpu/models/__init__.py::select (reference
architectures/__init__.py:11-34) for the CvT, Swin and ViT/DeiT arches; the
other backbones come with later slices of the port.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .cvt import CvTNetwork
from .swin import SwinNetwork
from .vit import ViTNetwork


def select(arch: str, opt, generator: Optional[torch.Generator] = None, img_size: int = 224):
    """arch string -> ``nn.Module`` with the shared forward contract
    ``model(x, ret_attn) -> (embed, (enc_out, token_map), aux)``, randomly
    initialised from ``generator``.  `_normalize` in the arch string
    L2-normalises the embedding.  ``img_size`` (the input's side in pixels)
    sizes the ViT's position embedding, as Flax sizes it from the first
    input."""
    a = arch.lower()
    if a.startswith("vit") or a.startswith("deit"):
        return ViTNetwork(embed_dim=opt.embed_dim, normalize="normalize" in a,
                          qk_block=opt.blk_ind, img_size=img_size, generator=generator)
    if "swin" in a:
        # full Swin-T runs only at sizes where every stage's resolution is a
        # multiple of the window (224 px and up), so its bias tables never
        # clamp and do not depend on the input size
        return SwinNetwork(embed_dim=opt.embed_dim, normalize="normalize" in a,
                           generator=generator)
    if a.startswith("cvt") and "diml" not in a and "fp" not in a:
        return CvTNetwork(
            embed_dim=opt.embed_dim, normalize="normalize" in a, generator=generator
        )
    raise NotImplementedError(
        f"architecture {arch} is not ported yet "
        "(the port has CvTNetwork, SwinNetwork and ViTNetwork)"
    )


def frozen_param_mask(arch: str, model: torch.nn.Module) -> Dict[str, bool]:
    """Parameter name -> trainable, for the CvT, Swin and ViT/DeiT arches
    (those branches of the JAX package's ``frozen_param_mask``): for CvT,
    ``_frozen`` freezes stages 0 and 1 (reference cvt.py:724-733); for Swin
    and ViT/DeiT it freezes the backbone and trains the head only; ``_noln``
    freezes the LayerNorms (cvt.py:858-864).  Frozen parameters train at
    learning rate 0."""
    a = arch.lower()
    out = {}
    for name, _ in model.named_parameters():
        trainable = True
        if "frozen" in a and a.startswith("cvt") and ("stage0" in name or "stage1" in name):
            trainable = False
        if "noln" in a and ".ln." in f".{name}":
            trainable = False
        if "frozen" in a and (a.startswith("vit") or a.startswith("deit") or "swin" in a):
            trainable = trainable and (name.startswith("head") or "head." in name)
        out[name] = trainable
    return out
