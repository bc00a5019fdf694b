"""ResNet-50 backbone and its DIML per-patch variant (PyTorch).

Port of vit_reranking_tpu/models/resnet.py (reference architectures/
resnet50.py:35-50, resnet50_diml.py:25-45): the torchvision topology
(7x7 stem, max pool, bottleneck stages of 3, 4, 6 and 3 blocks, the stride
on the 3x3 conv), NCHW here where the JAX package is NHWC.  Module and
parameter names follow the Flax names (``trunk.layer2_0.downsample_conv``
...), so ``weights.load_jax_params`` carries its variables over with no
table of renames.

``bn_frozen`` (the `_frozen` arches) makes every BatchNorm read its running
statistics in training mode too and never update them; their scale and
bias still train.  ``dtype`` is the trunk's compute dtype, cast where the
JAX model casts: the input, the convolutions and the BatchNorms' outputs in
it (BatchNorm statistics f32), the trunk's output back in f32, the heads
f32.  The convolutions run through ``torch.nn.functional.conv2d`` (cuDNN
on the card), as the JAX package runs them through XLA: no port kernel.
``IRResNet`` (GeM pooling) comes with the MSLS slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.similarity import l2_normalize
from .common import BatchNorm2d, Conv2d, init_weights

# (blocks, width, stride) of layer1..layer4
STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))


def _bn(channels: int, frozen: bool, dtype: torch.dtype) -> BatchNorm2d:
    # Flax momentum 0.9 is torch's 0.1
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1, compute_dtype=dtype, frozen=frozen)


def _conv(cin: int, cout: int, kernel: int, stride: int, padding: int,
          dtype: torch.dtype) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride, padding, bias=False, compute_dtype=dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 (x4) with a projected shortcut on the
    first block of a stage (JAX resnet.py:34-68)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 downsample: bool = False, bn_frozen: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = features * 4
        self.conv1 = _conv(in_channels, features, 1, 1, 0, dtype)
        self.bn1 = _bn(features, bn_frozen, dtype)
        self.conv2 = _conv(features, features, 3, stride, 1, dtype)
        self.bn2 = _bn(features, bn_frozen, dtype)
        self.conv3 = _conv(features, out, 1, 1, 0, dtype)
        self.bn3 = _bn(out, bn_frozen, dtype)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = _conv(in_channels, out, 1, stride, 0, dtype)
            self.downsample_bn = _bn(out, bn_frozen, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return F.relu(y + residual)


class ResNet50Trunk(nn.Module):
    """conv1 .. layer4: (B, 3, H, W) -> the (B, 2048, H/32, W/32) map, f32."""

    def __init__(self, bn_frozen: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, 3, dtype)
        self.bn1 = _bn(64, bn_frozen, dtype)
        self.blocks = []
        cin = 64
        for li, (blocks, feats, stride) in enumerate(STAGES):
            for bi in range(blocks):
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, Bottleneck(cin, feats, stride if bi == 0 else 1,
                                                 bi == 0, bn_frozen, dtype))
                self.blocks.append(name)
                cin = feats * 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        # padding 1 pads with -inf, as Flax's max_pool
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        # the heads, pooling and OT math downstream are f32
        return x.float()


def _token_map(feat: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C), the JAX package's row-major token order."""
    return feat.flatten(2).transpose(1, 2)


class ResNet50Network(nn.Module):
    """Retrieval wrapper (reference resnet50.Network): ``forward(x, ret_attn)``
    returns ``(embed, (enc_out, token_map), {})`` with enc_out the (B, 2048)
    mean of the map and token_map (B, H*W, 2048)."""

    def __init__(self, embed_dim: int = 128, normalize: bool = True, bn_frozen: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.normalize = normalize
        self.trunk = ResNet50Trunk(bn_frozen, dtype)
        self.last_linear = nn.Linear(2048, embed_dim)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor, ret_attn: bool = False):
        feat = self.trunk(x)
        enc_out = feat.mean(dim=(2, 3))
        out = self.last_linear(enc_out)
        if self.normalize:
            out = l2_normalize(out, dim=-1)
        return out, (enc_out, _token_map(feat)), {}


class ResNet50DIML(nn.Module):
    """Per-patch embedding head (reference resnet50_diml.py:25-45): the 1x1
    conv ``last_linear`` (a Linear over channels, as Flax's Dense) on the
    map.  ``forward(x, ret_attn)`` returns ``(per_feat (B, H, W, D),
    (enc_out, token_map), {})``, per_feat in the JAX package's layout and
    enc_out the UNprojected (B, 2048) mean of the map."""

    def __init__(self, embed_dim: int = 128, bn_frozen: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trunk = ResNet50Trunk(bn_frozen, dtype)
        self.last_linear = nn.Linear(2048, embed_dim)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor, ret_attn: bool = False):
        feat = self.trunk(x)
        per_feat = self.last_linear(feat.permute(0, 2, 3, 1))
        return per_feat, (feat.mean(dim=(2, 3)), _token_map(feat)), {}
