"""Deterministic spatial resampling as static matrix contractions.

Port of vit_reranking_tpu/ops/pooling.py: ``AdaptiveAvgPool2d`` and
``Upsample(bilinear, align_corners=True)`` written as separable (out, in)
weight matrices applied with einsum, so the port sums in the same order as
the JAX package (the reference's rerank path uses both, evaluation/
eval_cvt_diml.py:54-70,119,228-234).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """P[i, j] = 1/len(window_i) if j in window_i, matching torch AdaptiveAvgPool."""
    P = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -(-((i + 1) * in_size) // out_size)  # ceil
        P[i, start:end] = 1.0 / (end - start)
    return P


@functools.lru_cache(maxsize=64)
def _bilinear_ac_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Align-corners bilinear interpolation matrix (torch Upsample semantics)."""
    W = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1:
        W[0, 0] = 1.0
        return W
    scale = (in_size - 1) / (out_size - 1)
    for i in range(out_size):
        x = i * scale
        lo = int(np.floor(x))
        hi = min(lo + 1, in_size - 1)
        frac = x - lo
        W[i, lo] += 1.0 - frac
        W[i, hi] += frac
    return W


def _separable(x: torch.Tensor, Mh: np.ndarray, Mw: np.ndarray) -> torch.Tensor:
    Mh = torch.from_numpy(Mh).to(x.device)
    Mw = torch.from_numpy(Mw).to(x.device)
    x = torch.einsum("hH,...HW->...hW", Mh, x.float())
    return torch.einsum("wW,...HW->...Hw", Mw, x)


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    """x (..., H, W) -> (..., h, w), torch.nn.AdaptiveAvgPool2d semantics."""
    h, w = (output_size, output_size) if isinstance(output_size, int) else output_size
    return _separable(
        x, _adaptive_pool_matrix(x.shape[-2], h), _adaptive_pool_matrix(x.shape[-1], w)
    )


def upsample_bilinear_ac(x: torch.Tensor, output_size) -> torch.Tensor:
    """x (..., H, W) -> (..., h, w), torch Upsample(bilinear, align_corners=True)."""
    h, w = (output_size, output_size) if isinstance(output_size, int) else output_size
    return _separable(
        x, _bilinear_ac_matrix(x.shape[-2], h), _bilinear_ac_matrix(x.shape[-1], w)
    )


def grid_resize_tokens(feat: torch.Tensor, grid: int) -> torch.Tensor:
    """Resize a (..., C, H, W) token map to (..., C, grid, grid).

    The reference's eval-time rule (evaluation/eval_diml.py:90-96,
    eval_cvt_diml.py:228-234): plain adaptive pool when the source divides
    evenly into the grid, otherwise bilinear-upsample to 4*grid first.
    """
    H = feat.shape[-1]
    if H == grid:
        return feat
    if H % grid == 0:
        return adaptive_avg_pool2d(feat, grid)
    return adaptive_avg_pool2d(upsample_bilinear_ac(feat, grid * 4), grid)
