"""Model registry — substring dispatch over the arch string.

Port of vit_reranking_tpu/models/__init__.py::select (reference
architectures/__init__.py:11-34) for the CvT arches; the other backbones come
with later slices of the port.
"""

from __future__ import annotations

from typing import Optional

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
