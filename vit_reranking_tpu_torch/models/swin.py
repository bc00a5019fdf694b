"""Swin-T backbone in PyTorch: windowed attention with a relative position
bias, shifted windows, patch merging.

Port of vit_reranking_tpu/models/swin.py (the `swin_tiny_patch4_window7_224`
topology of reference architectures/swin.py:13-61): patch 4, dims
96/192/384/768, depths 2/2/6/2, heads 3/6/12/24, window 7, exact erf GELU,
f32 LayerNorms.  The forward returns the final 7x7x768 token map after the
trunk LayerNorm, and the head applied to it (the Swin rerank path pools it
to the DIML grid, reference eval_swin_diml.py:183-195).

Module and parameter names follow the Flax names (``layer0_block0.attn.qkv``,
``layer0_downsample.reduction`` ...) so that ``weights.py`` carries a Flax
Swin tree across.  Images are NCHW.  A PyTorch module sizes its parameters
when it is built, so ``SwinNetwork`` takes the input size: a stage whose
resolution does not exceed the window gets the clamped window's bias table,
as Flax sizes it on first use.  Window attention goes through
``ops/swin_attention.py::swin_attention`` (kernels K4a/K4b on the card) when
``USE_SWIN_WINDOW_KERNEL`` is on; otherwise, and where the dispatcher
returns None, it materialises the probabilities as the JAX package does.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops.similarity import l2_normalize
from ..ops.swin_attention import swin_attention
from .common import DropPath, Mlp, exact_gelu, init_weights, trunc_normal_

# The window-attention kernels, off by default as in the JAX package
# (models/swin.py:73); SWIN_WINDOW_ATTENTION=1 turns them on.  Read at call
# time, so a caller may flip the module global.
USE_SWIN_WINDOW_KERNEL = os.environ.get("SWIN_WINDOW_ATTENTION", "0") == "1"


@functools.lru_cache(maxsize=8)
def _relative_position_index(window: int) -> np.ndarray:
    """(W^2, W^2) indices into the (2W-1)^2 bias table (standard Swin)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, W^2, W^2)
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]).astype(np.int32)


@functools.lru_cache(maxsize=32)
def _shift_attn_mask(H: int, W: int, window: int, shift: int) -> np.ndarray:
    """(nW, W^2, W^2) additive mask for shifted windows (0 or -100)."""
    img = np.zeros((H, W), np.int32)
    cnt = 0
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(H // window, window, W // window, window)
    wins = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = wins[:, None, :] != wins[:, :, None]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _mask_on(H: int, W: int, window: int, shift: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_shift_attn_mask(H, W, window, shift)).to(device)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, window^2, C), windows in row-major order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def window_reverse(wins: torch.Tensor, window: int, H: int, W: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`: (B * nW, window^2, C) ->
    (B, H, W, C)."""
    B = wins.shape[0] // ((H // window) * (W // window))
    x = wins.reshape(B, H // window, W // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm (eps 1e-5) computed in f32 whatever the input's dtype, with
    Flax's ``scale``/``bias`` as ``weight``/``bias`` of this module itself."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


class WindowAttention(nn.Module):
    """Multi-head attention inside each window, with a learned relative
    position bias (reference architectures/swin.py via timm)."""

    def __init__(self, dim: int, num_heads: int, window: int = 7):
        super().__init__()
        self.dim, self.num_heads, self.window = dim, num_heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(window).astype(np.int64)),
            persistent=False,
        )

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                n_windows: int = 1) -> torch.Tensor:
        Bw, T, C = x.shape
        H = self.num_heads
        hd = self.dim // H
        qkv = self.qkv(x).reshape(Bw, T, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        bias = bias.reshape(T, T, H).permute(2, 0, 1)  # (H, T, T)

        if USE_SWIN_WINDOW_KERNEL:
            out = swin_attention(q, k, v, bias, mask, hd**-0.5, n_windows=n_windows)
            if out is not None:
                return self.proj(out.transpose(1, 2).reshape(Bw, T, self.dim))

        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd**-0.5
        attn = attn + bias[None].float()
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(Bw // nW, nW, H, T, T) + mask[None, :, None].float()
            attn = attn.reshape(Bw, H, T, T)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn.to(v.dtype), v)
        return self.proj(out.transpose(1, 2).reshape(Bw, T, self.dim))


class SwinBlock(nn.Module):
    """Pre-norm (shifted) window attention block and MLP, for one stage
    resolution ``res`` (H = W)."""

    def __init__(self, dim: int, num_heads: int, res: int, window: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm32(dim)
        # official Swin rule (JAX models/swin.py:215-216): when the resolution
        # does not exceed the window, attention is global over a clamped window
        self.attn = WindowAttention(dim, num_heads, min(window, res))
        self.dp1 = DropPath(drop_path)
        self.norm2 = LayerNorm32(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, act=exact_gelu)
        self.dp2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, L, C = x.shape
        window = min(self.window, H, W)
        shift = 0 if min(H, W) <= self.window else self.shift
        if window != self.attn.window:
            raise ValueError(
                f"SwinBlock built for a {self.attn.window}-token window, given {H}x{W} tokens"
            )
        res = x
        y = self.norm1(x).reshape(B, H, W, C)
        mask = None
        if shift > 0:
            y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
            mask = _mask_on(H, W, window, shift, y.device)
        wins = self.attn(window_partition(y, window), mask,
                         n_windows=(H // window) * (W // window))
        y = window_reverse(wins, window, H, W)
        if shift > 0:
            y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
        x = res + self.dp1(y.reshape(B, L, C))
        return x + self.dp2(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """2x2 token merge: concatenate, LayerNorm, linear 4C -> 2C, no bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm32(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, L, C = x.shape
        x = x.reshape(B, H, W, C)
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1
        ).reshape(B, (H // 2) * (W // 2), 4 * C)
        return self.reduction(self.norm(x))


class SwinNetwork(nn.Module):
    """Swin-T retrieval wrapper (reference architectures/swin.py:13-61).

    ``forward(x (B, 3, img_size, img_size))`` returns
    ``(embed, (enc_out, token_map), {"head_tokens": head(token_map)})``:
    token_map is the LayerNorm'd final token map (B, L, C)."""

    def __init__(self, embed_dim: int = 128, normalize: bool = True, dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window: int = 7, patch: int = 4, drop_path_rate: float = 0.2,
                 img_size: int = 224, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize, self.depths, self.patch = normalize, tuple(depths), patch
        self.patch_embed_proj = nn.Conv2d(3, dim, patch, patch)
        self.patch_embed_norm = LayerNorm32(dim)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        res, b = img_size // patch, 0
        for li, depth in enumerate(depths):
            for bi in range(depth):
                self.add_module(f"layer{li}_block{bi}", SwinBlock(
                    dim, num_heads[li], res, window=window,
                    shift=0 if bi % 2 == 0 else window // 2, drop_path=float(dpr[b]),
                ))
                b += 1
            if li < len(depths) - 1:
                self.add_module(f"layer{li}_downsample", PatchMerging(dim))
                res, dim = res // 2, dim * 2
        self.norm = LayerNorm32(dim)
        self.head = nn.Linear(dim, embed_dim)
        init_weights(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, WindowAttention):
                    trunc_normal_(m.relative_position_bias_table, 0.02, generator)

    def forward(self, x: torch.Tensor, ret_attn: bool = False):
        x = self.patch_embed_proj(x.float())
        B, C, H, W = x.shape
        x = self.patch_embed_norm(x.flatten(2).transpose(1, 2))
        for li, depth in enumerate(self.depths):
            for bi in range(depth):
                x = getattr(self, f"layer{li}_block{bi}")(x, H, W)
            if li < len(self.depths) - 1:
                x = getattr(self, f"layer{li}_downsample")(x, H, W)
                H, W = H // 2, W // 2
        no_avg_feat = self.norm(x).float()  # (B, 49, 768): head and rerank features in f32
        enc_out = no_avg_feat.mean(dim=1)
        out = self.head(enc_out)
        if self.normalize:
            out = l2_normalize(out, dim=-1)
        aux: Dict[str, Any] = {"head_tokens": self.head(no_avg_feat)}
        return out, (enc_out, no_avg_feat), aux
