"""Model registry — substring dispatch over the arch string.

Port of vit_reranking_tpu/models/__init__.py::select (reference
architectures/__init__.py:11-34) for the ResNet-50, ResNet-50-DIML, CvT,
CvT-DIML, Swin and ViT/DeiT arches; the other backbones come with later
slices of the port.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .cvt import CvTDIML, CvTNetwork
from .resnet import ResNet50DIML, ResNet50Network
from .swin import SwinNetwork
from .vit import ViTNetwork


def select(arch: str, opt, generator: Optional[torch.Generator] = None, img_size: int = 224):
    """arch string -> ``nn.Module`` with the shared forward contract
    ``model(x, ret_attn) -> (embed, (enc_out, token_map), aux)``, randomly
    initialised from ``generator``.  `_normalize` in the arch string
    L2-normalises the embedding.  ``img_size`` (the input's side in pixels)
    sizes the ViT's position embedding, as Flax sizes it from the first
    input.

    ``opt.bf16`` picks the activation compute dtype (bf16 or f32) and
    ``opt.narrow_sm`` the narrowed softmax, as the JAX package passes them
    (models/__init__.py:37-48, :87, :104); `_frozen` freezes every
    BatchNorm of a ResNet, and `_diml` arches return the per-patch map
    first.  The branches go in the JAX package's order; ``irresnet50*`` and
    ``*netvlad*`` raise ``NotImplementedError`` naming the missing model."""
    a = arch.lower()
    bf16 = bool(getattr(opt, "bf16", False))
    dtype = torch.bfloat16 if bf16 else torch.float32
    narrow_sm = bool(getattr(opt, "narrow_sm", False))
    frozen = "frozen" in a
    if a.startswith("resnet50_diml"):
        return ResNet50DIML(embed_dim=opt.embed_dim, bn_frozen=frozen, generator=generator,
                            dtype=dtype)
    if a.startswith("resnet50"):
        return ResNet50Network(embed_dim=opt.embed_dim, normalize="normalize" in a,
                               bn_frozen=frozen, generator=generator, dtype=dtype)
    if a.startswith("irresnet50"):
        raise NotImplementedError(
            f"architecture {arch}: IRResNet (ResNet-50 with GeM pooling) is not ported yet")
    if a.startswith("vit") or a.startswith("deit"):
        return ViTNetwork(embed_dim=opt.embed_dim, normalize="normalize" in a,
                          qk_block=opt.blk_ind, img_size=img_size, generator=generator,
                          narrow_sm=narrow_sm, dtype=dtype)
    if "netvlad" in a:
        raise NotImplementedError(
            f"architecture {arch}: NetVLAD and PatchNetVLAD are not ported yet")
    if "swin" in a:
        # full Swin-T runs only at sizes where every stage's resolution is a
        # multiple of the window (224 px and up), so its bias tables never
        # clamp and do not depend on the input size
        return SwinNetwork(embed_dim=opt.embed_dim, normalize="normalize" in a,
                           generator=generator, narrow_sm=narrow_sm, dtype=dtype)
    if a.startswith("cvt") and "diml" in a:
        return CvTDIML(embed_dim=opt.embed_dim, grid_size=opt.grid_size, generator=generator,
                       narrow_sm=narrow_sm, dtype=dtype)
    if a.startswith("cvt") and "fp" not in a:
        return CvTNetwork(
            embed_dim=opt.embed_dim, normalize="normalize" in a, generator=generator,
            narrow_sm=narrow_sm, dtype=dtype,
        )
    raise NotImplementedError(
        f"architecture {arch} is not ported yet (the port has ResNet50Network, "
        "ResNet50DIML, CvTNetwork, CvTDIML, SwinNetwork and ViTNetwork)"
    )


def frozen_param_mask(arch: str, model: torch.nn.Module) -> Dict[str, bool]:
    """Parameter name -> trainable, for the ported arches (those branches
    of the JAX package's ``frozen_param_mask``, models/__init__.py:110-137):
    for CvT and CvT-DIML, ``_frozen`` freezes stages 0 and 1 (reference
    cvt.py:724-733); for Swin and ViT/DeiT it freezes the backbone and
    trains the head only; ``_noln`` freezes the LayerNorms (cvt.py:858-864).
    A ResNet's ``_frozen`` masks no parameter: it freezes the BatchNorm
    statistics inside the model, and their scale and bias still train.
    Frozen parameters train at learning rate 0."""
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
