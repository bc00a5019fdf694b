"""DeiT/ViT-small backbone in PyTorch.

Port of vit_reranking_tpu/models/vit.py::ViTNetwork (the timm
`deit_small_patch16_224` topology of reference architectures/vit.py:13-60):
patch 16, dim 384, 6 heads of 64, 12 blocks, pre-norm blocks with f32
LayerNorms (eps 1e-6) and the exact erf GELU.  The forward exposes the cls
token and the patch tokens after the final LayerNorm; one ``head`` Linear
projects both the cls embedding and the patch tokens (``head_tokens``).
With ``ret_attn`` it also returns the q/k projections of block
``qk_block`` (B, heads, T+1, hd), which the qk rerank method reads
(reference evaluation/eval_attn_diml.py:18-38).

Module and parameter names follow the Flax names (``patch_embed_proj``,
``cls_token``, ``pos_embed``, ``block{i}.attn.qkv`` ...), so ``weights.py``
carries a Flax ViT tree across.  Images are NCHW.  Flax sizes ``pos_embed``
from the first input; a PyTorch module sizes its parameters when it is
built, so ``ViTNetwork`` takes the input size.  Attention materialises the
(T, T) probabilities, as the JAX model does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

from ..ops.similarity import l2_normalize
from .common import Mlp, exact_gelu, init_weights, trunc_normal_


class ViTAttention(nn.Module):
    """Multi-head self-attention; the qkv projection splits as
    (B, T, 3, heads, hd)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, ret_qk: bool = False):
        B, T, C = x.shape
        hd = C // self.num_heads
        qkv = self.qkv(x).reshape(B, T, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, h, T, hd)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * hd**-0.5, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, C)
        return self.proj(out), ((q, k) if ret_qk else None)


class ViTBlock(nn.Module):
    """Pre-norm attention and MLP block (drop-path 0, as the JAX model)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = ViTAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, act=exact_gelu)

    def forward(self, x: torch.Tensor, ret_qk: bool = False):
        y, qk = self.attn(self.norm1(x), ret_qk)
        x = x + y
        return x + self.mlp(self.norm2(x)), qk


class ViTNetwork(nn.Module):
    """DeiT-small retrieval wrapper (reference architectures/vit.py:13-60).

    ``forward(x (B, 3, H, W))`` returns ``(embed, (enc_out, token_map),
    aux)``: enc_out is the cls token and token_map the (B, T, dim) patch
    tokens after the final LayerNorm; ``aux["head_tokens"]`` is the head
    applied to the patch tokens, and with ``ret_attn`` ``aux["q"]`` and
    ``aux["k"]`` are block ``qk_block``'s projections."""

    def __init__(self, embed_dim: int = 128, normalize: bool = True, dim: int = 384,
                 depth: int = 12, num_heads: int = 6, patch: int = 16, qk_block: int = 0,
                 img_size: Union[int, Tuple[int, int]] = 224,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize, self.depth, self.qk_block = normalize, depth, qk_block
        H, W = (img_size, img_size) if isinstance(img_size, int) else img_size
        self.patch_embed_proj = nn.Conv2d(3, dim, patch, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (H // patch) * (W // patch) + 1, dim))
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(dim, num_heads))
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, embed_dim)
        init_weights(self, generator)
        with torch.no_grad():
            trunc_normal_(self.cls_token, 0.02, generator)
            trunc_normal_(self.pos_embed, 0.02, generator)

    def forward(self, x: torch.Tensor, ret_attn: bool = False):
        x = self.patch_embed_proj(x.float())
        B = x.shape[0]
        tokens = x.flatten(2).transpose(1, 2)  # (B, H*W, dim), row-major patches
        if tokens.shape[1] + 1 != self.pos_embed.shape[1]:
            raise ValueError(
                f"ViTNetwork built for {self.pos_embed.shape[1] - 1} patches, given "
                f"{tokens.shape[1]}: build it with the input's img_size"
            )
        tokens = torch.cat([self.cls_token.expand(B, -1, -1), tokens], dim=1) + self.pos_embed
        qk_out = None
        for i in range(self.depth):
            tokens, qk = getattr(self, f"block{i}")(tokens, ret_attn and i == self.qk_block)
            if qk is not None:
                qk_out = qk
        tokens = self.norm(tokens)
        enc_out = tokens[:, 0]
        no_avg_feat = tokens[:, 1:]
        out = self.head(enc_out)
        if self.normalize:
            out = l2_normalize(out, dim=-1)
        aux: Dict[str, Any] = {"head_tokens": self.head(no_avg_feat)}
        if qk_out is not None:
            aux["q"], aux["k"] = qk_out
        return out, (enc_out, no_avg_feat), aux
