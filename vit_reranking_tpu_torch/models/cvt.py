"""CvT-13 (Convolutional Vision Transformer) in PyTorch — the primary backbone.

Port of vit_reranking_tpu/models/cvt.py (reference architectures/cvt.py:
651-675 spec, :82-500 modules): 3 stages, conv patch embedding (7/3/3
kernels, 4/2/2 strides), depthwise-conv + BN q/k/v projections with stride-2
pooled K/V, cls token only in stage 2, QuickGELU MLPs, fp32 LayerNorms,
attention scale = full-dim ** -0.5 (reference cvt.py:105 — NOT per-head).

Module and parameter names follow the JAX package's Flax names
(``trunk.stage0.block0.attn.conv_proj_q.conv`` ...) so ``weights.py`` can
carry its variables over.  Images are NCHW; attention-rollout maps are
filtered and pooled to the target grid inside the forward pass
(ops/rollout.py), as in the JAX package.  Stages without a cls token send
attention through ``ops/attention.py::cvt_attention`` (kernel K3 on the card)
under the JAX package's conditions (cvt.py:224-239), except that the JAX
package's "only on a TPU" becomes "always": on the CPU the wrapper runs K3's
plain version, which computes the same function.  ``ret_attn`` (rollout)
keeps the materialising path, which it needs the probabilities of.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops import attention as kv_attention
from ..ops.rollout import block_rollout_map
from ..ops.similarity import l2_normalize
from .common import BatchNorm2d, DropPath, LayerNormFp32, Mlp, init_weights, trunc_normal_


@dataclass(frozen=True)
class CvTSpec:
    """CvT-13 stage spec (reference cvt.py:651-675)."""

    patch_size: Sequence[int] = (7, 3, 3)
    patch_stride: Sequence[int] = (4, 2, 2)
    patch_padding: Sequence[int] = (2, 1, 1)
    dim_embed: Sequence[int] = (64, 192, 384)
    num_heads: Sequence[int] = (1, 3, 6)
    depth: Sequence[int] = (1, 2, 10)
    mlp_ratio: Sequence[float] = (4.0, 4.0, 4.0)
    qkv_bias: Sequence[bool] = (True, True, True)
    cls_token: Sequence[bool] = (False, False, True)
    drop_rate: Sequence[float] = (0.0, 0.0, 0.0)
    attn_drop_rate: Sequence[float] = (0.0, 0.0, 0.0)
    drop_path_rate: Sequence[float] = (0.0, 0.0, 0.1)
    kernel_qkv: Sequence[int] = (3, 3, 3)
    padding_kv: Sequence[int] = (1, 1, 1)
    stride_kv: Sequence[int] = (2, 2, 2)
    padding_q: Sequence[int] = (1, 1, 1)
    stride_q: Sequence[int] = (1, 1, 1)

    @property
    def num_stages(self) -> int:
        return len(self.depth)


CVT13_SPEC = CvTSpec()

# Route cls-free stages' attention (not ret_attn, attn_drop 0) through
# ops/attention.py::cvt_attention, which itself gates on the score count
# (KV_RESIDENT_MIN_SCORES: stage 0 only at 224 px).
USE_KV_RESIDENT_ATTENTION = True


class ConvProj(nn.Module):
    """Depthwise conv + BN projection used for q/k/v (reference cvt.py:131-151).

    Input (B, C, H, W) -> (B, H'*W', C) flattened tokens.
    """

    def __init__(self, dim: int, kernel: int, stride: int, padding: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, kernel, stride, padding, groups=dim, bias=False)
        self.bn = BatchNorm2d(dim, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x)).flatten(2).transpose(1, 2)


class CvTAttention(nn.Module):
    """Multi-head attention with conv-projected q/k/v (reference cvt.py:82-220)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool, kernel: int,
                 stride_q: int, stride_kv: int, padding_q: int, padding_kv: int,
                 with_cls_token: bool, attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.with_cls_token = with_cls_token
        self.conv_proj_q = ConvProj(dim, kernel, stride_q, padding_q)
        self.conv_proj_k = ConvProj(dim, kernel, stride_kv, padding_kv)
        self.conv_proj_v = ConvProj(dim, kernel, stride_kv, padding_kv)
        self.proj_q = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj_k = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj_v = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x: torch.Tensor, h: int, w: int, ret_attn: bool = False):
        B, T, C = x.shape
        if self.with_cls_token:
            cls_tok, tokens = x[:, :1], x[:, 1:]
        else:
            cls_tok, tokens = None, x
        spatial = tokens.reshape(B, h, w, C).permute(0, 3, 1, 2)
        q = self.conv_proj_q(spatial)
        k = self.conv_proj_k(spatial)
        v = self.conv_proj_v(spatial)
        if cls_tok is not None:
            q = torch.cat([cls_tok, q], dim=1)
            k = torch.cat([cls_tok, k], dim=1)
            v = torch.cat([cls_tok, v], dim=1)

        hd = C // self.num_heads
        heads = lambda t: t.reshape(B, -1, self.num_heads, hd).transpose(1, 2)
        q = heads(self.proj_q(q))
        k = heads(self.proj_k(k))
        v = heads(self.proj_v(v))
        # scale uses the FULL dim, not head dim (reference cvt.py:105);
        # scores and softmax in f32
        scale = self.dim**-0.5
        if (USE_KV_RESIDENT_ATTENTION and not ret_attn and cls_tok is None
                and self.attn_drop.p == 0.0):
            out = kv_attention.cvt_attention(q, k, v, scale)
            if out is not None:
                out = out.transpose(1, 2).reshape(B, -1, C)
                return self.proj_drop(self.proj(out)), None
        score = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        attn = self.attn_drop(torch.softmax(score, dim=-1))
        out = torch.matmul(attn.to(v.dtype), v)
        out = out.transpose(1, 2).reshape(B, -1, C)
        out = self.proj_drop(self.proj(out))
        return out, (attn if ret_attn else None)


class CvTBlock(nn.Module):
    """Pre-norm transformer block (reference cvt.py:297-344)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, qkv_bias: bool,
                 drop: float, attn_drop: float, drop_path: float, kernel: int,
                 stride_q: int, stride_kv: int, padding_q: int, padding_kv: int,
                 with_cls_token: bool):
        super().__init__()
        self.norm1 = LayerNormFp32(dim)
        self.attn = CvTAttention(dim, num_heads, qkv_bias, kernel, stride_q, stride_kv,
                                 padding_q, padding_kv, with_cls_token, attn_drop, drop)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNormFp32(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dropout=drop)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, h: int, w: int, ret_attn: bool = False):
        attn_out, weights = self.attn(self.norm1(x), h, w, ret_attn)
        x = x + self.drop_path1(attn_out)
        x = x + self.drop_path2(self.mlp(self.norm2(x)))
        return x, weights


class CvTStage(nn.Module):
    """Conv embed + blocks (reference VisionTransformer, cvt.py:382-500)."""

    def __init__(self, spec: CvTSpec, index: int, in_chans: int, rollout_grid: int = 7):
        super().__init__()
        i = index
        s = spec
        self.rollout_grid = rollout_grid
        self.with_cls = s.cls_token[i]
        dim = s.dim_embed[i]
        self.patch_embed_proj = nn.Conv2d(
            in_chans, dim, s.patch_size[i], s.patch_stride[i], s.patch_padding[i]
        )
        self.patch_embed_norm = LayerNormFp32(dim)
        if self.with_cls:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_drop = nn.Dropout(s.drop_rate[i])
        dpr = [float(r) for r in np.linspace(0.0, s.drop_path_rate[i], s.depth[i])]
        self.depth = s.depth[i]
        for j in range(self.depth):
            self.add_module(f"block{j}", CvTBlock(
                dim=dim, num_heads=s.num_heads[i], mlp_ratio=s.mlp_ratio[i],
                qkv_bias=s.qkv_bias[i], drop=s.drop_rate[i],
                attn_drop=s.attn_drop_rate[i], drop_path=dpr[j],
                kernel=s.kernel_qkv[i], stride_q=s.stride_q[i],
                stride_kv=s.stride_kv[i], padding_q=s.padding_q[i],
                padding_kv=s.padding_kv[i], with_cls_token=self.with_cls,
            ))

    def forward(self, x: torch.Tensor, ret_attn: bool = False):
        x = self.patch_embed_proj(x)
        B, C, H, W = x.shape
        tokens = self.patch_embed_norm(x.flatten(2).transpose(1, 2))
        if self.with_cls:
            tokens = torch.cat([self.cls_token.expand(B, -1, -1), tokens], dim=1)
        tokens = self.pos_drop(tokens)
        rollout_maps = []
        for j in range(self.depth):
            tokens, weights = getattr(self, f"block{j}")(tokens, H, W, ret_attn)
            if ret_attn:
                # filter + pool to grid in-forward (never keep all raw maps)
                rollout_maps.append(
                    block_rollout_map(weights, self.rollout_grid, has_cls=self.with_cls)
                )
        cls_out = None
        if self.with_cls:
            cls_out, tokens = tokens[:, :1], tokens[:, 1:]
        x = tokens.transpose(1, 2).reshape(B, C, H, W)
        return x, cls_out, rollout_maps


class ConvolutionalVisionTransformer(nn.Module):
    """3-stage CvT trunk (reference cvt.py:503-648)."""

    def __init__(self, spec: CvTSpec = CVT13_SPEC, rollout_grid: int = 7):
        super().__init__()
        self.num_stages = spec.num_stages
        in_chans = 3
        for i in range(spec.num_stages):
            self.add_module(f"stage{i}", CvTStage(spec, i, in_chans, rollout_grid))
            in_chans = spec.dim_embed[i]

    def forward(self, x: torch.Tensor, ret_attn: bool = False):
        rollout_maps: List[torch.Tensor] = []
        cls_tokens = None
        for i in range(self.num_stages):
            x, cls_tokens, maps = getattr(self, f"stage{i}")(x, ret_attn)
            rollout_maps.extend(maps)
        return x, cls_tokens, rollout_maps


class CvTNetwork(nn.Module):
    """Retrieval wrapper (reference cvt.Network, cvt.py:678-749).

    ``forward(x (B, 3, H, W), ret_attn)`` returns
    ``(embed, (enc_out, no_avg_feat), aux)``: no_avg_feat is the LayerNorm'd
    token map (B, H*W, C); aux carries ``head_tokens`` (B, H*W, embed_dim)
    and, with ``ret_attn``, ``rollout_maps`` (L, B, G, G).
    """

    def __init__(self, embed_dim: int = 128, normalize: bool = True, rollout_grid: int = 7,
                 spec: CvTSpec = CVT13_SPEC, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize = normalize
        self.trunk = ConvolutionalVisionTransformer(spec, rollout_grid)
        dim = spec.dim_embed[-1]
        self.norm = LayerNormFp32(dim)
        self.head = nn.Linear(dim, embed_dim)
        init_weights(self, generator)
        with torch.no_grad():
            for i in range(spec.num_stages):
                stage = getattr(self.trunk, f"stage{i}")
                if stage.with_cls:
                    trunc_normal_(stage.cls_token, 0.02, generator)

    def forward(self, x: torch.Tensor, ret_attn: bool = False):
        tokens_hw, cls_tok, rollout_maps = self.trunk(x, ret_attn)
        no_avg_feat = self.norm(tokens_hw.float().flatten(2).transpose(1, 2))
        enc_out = self.norm(cls_tok.float()).squeeze(1)
        out = self.head(enc_out)
        if self.normalize:
            out = l2_normalize(out, dim=-1)
        aux: Dict[str, Any] = {}
        if ret_attn:
            aux["rollout_maps"] = torch.stack(rollout_maps)  # (L, B, G, G)
        # eval path needs head-projected token maps (eval_cvt_diml.py:269-276)
        aux["head_tokens"] = self.head(no_avg_feat)
        return out, (enc_out, no_avg_feat), aux
