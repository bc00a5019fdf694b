"""Model registry — substring dispatch over the arch string.

Port of vit_reranking_tpu/models/__init__.py::select (reference
architectures/__init__.py:11-34) for the CvT arches; the other backbones come
with later slices of the port.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .cvt import CvTNetwork


def select(arch: str, opt, generator: Optional[torch.Generator] = None):
    """arch string -> ``nn.Module`` with the shared forward contract
    ``model(x, ret_attn) -> (embed, (enc_out, token_map), aux)``, randomly
    initialised from ``generator``.  `_normalize` in the arch string
    L2-normalises the embedding."""
    a = arch.lower()
    if a.startswith("cvt") and "diml" not in a and "fp" not in a:
        return CvTNetwork(
            embed_dim=opt.embed_dim, normalize="normalize" in a, generator=generator
        )
    raise NotImplementedError(
        f"architecture {arch} is not ported yet (the port has CvTNetwork only)"
    )


def frozen_param_mask(arch: str, model: torch.nn.Module) -> Dict[str, bool]:
    """Parameter name -> trainable, for the CvT arches (the CvT branches of
    the JAX package's ``frozen_param_mask``): ``_frozen`` freezes stages 0
    and 1 (reference cvt.py:724-733), ``_noln`` freezes the LayerNorms
    (cvt.py:858-864).  Frozen parameters train at learning rate 0."""
    a = arch.lower()
    out = {}
    for name, _ in model.named_parameters():
        trainable = True
        if "frozen" in a and a.startswith("cvt") and ("stage0" in name or "stage1" in name):
            trainable = False
        if "noln" in a and ".ln." in f".{name}":
            trainable = False
        out[name] = trainable
    return out
