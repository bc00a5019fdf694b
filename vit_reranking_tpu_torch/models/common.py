"""Shared model building blocks (PyTorch).

Forward contract for every backbone, as in the JAX package
(vit_reranking_tpu/models/common.py):

    model(x, ret_attn=...) -> (embedding, (enc_out, token_map), aux)

Images are NCHW float32 here (PyTorch's layout); token maps and every other
output keep the JAX package's layout.  Training or evaluation mode is the
module's own (``.train()`` / ``.eval()``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def trunc_normal_(t: torch.Tensor, std: float = 0.02,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Normal(0, std) truncated at +-2 std, drawn from ``generator``."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) (reference architectures/cvt.py:53-55)."""
    return x * torch.sigmoid(1.702 * x)


class LayerNormFp32(nn.Module):
    """LayerNorm (eps 1e-5) computed in fp32 regardless of input dtype
    (reference architectures/cvt.py:44-50)."""

    def __init__(self, dim: int):
        super().__init__()
        self.ln = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(x.float()).to(x.dtype)


class Mlp(nn.Module):
    """Two-layer MLP (reference cvt.py:58-79), QuickGELU unless ``act``
    says otherwise (Swin passes the exact erf GELU)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 dropout: float = 0.0, act: Callable[[torch.Tensor], torch.Tensor] = quick_gelu):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.drop = nn.Dropout(dropout)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.fc2(self.drop(self.act(self.fc1(x)))))


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with Flax's training-mode statistics update.

    Training mode normalises with the biased batch variance, as torch and
    Flax both do, and updates ``running_var`` with that same biased variance,
    as Flax's ``nn.BatchNorm`` does (torch's own update uses the unbiased
    one).  ``momentum`` 0.1 here is Flax's 0.9:
    ``running = 0.9 * running + 0.1 * batch``.  Evaluation mode reads the
    running statistics, as torch's does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            dims = (0, 2, 3)
            mean = torch.mean(x, dim=dims)
            var = torch.var(x, dim=dims, unbiased=False)
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
            self.running_var.mul_(keep).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y


class DropPath(nn.Module):
    """Stochastic depth: in training mode, keep each sample's residual branch
    with probability ``1 - rate`` and scale it by ``1 / (1 - rate)``, as the
    JAX package's DropPath does (identity in evaluation mode).  The draws come
    from PyTorch's global generator on the tensor's device, which
    ``cli/common.py::seed_everything`` seeds."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Random initialisation drawn from ``generator``, following the JAX
    package's initialisers: Dense kernels trunc-normal(0.02), conv kernels
    LeCun-normal (truncated), zero biases, unit norms."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                trunc_normal_(m.weight, 0.02, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                trunc_normal_(m.weight, math.sqrt(1.0 / fan_in), generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.reset_parameters()
