"""Attention rollout: per-block filtering/pooling + cumulative joint attention.

Port of vit_reranking_tpu/ops/rollout.py (itself a re-design of reference
evaluation/eval_cvt_diml.py:54-146): each block's attention map is filtered
and pooled to the target grid inside the forward pass, and the rollout is a
chain of (B, G, G) products.

The reference's discard step zeroes the *union* of every batch element's
lowest-10% indices in all elements (cross-batch advanced indexing,
eval_cvt_diml.py:91-97); the per-sample behaviour is the default here and
``compat_crossbatch=True`` reproduces the quirk.

Kernel K2 (``csrc/filter_threshold.cu``) replaces the TPU kernel
``_filter_threshold_kernel`` (vit_reranking_tpu/ops/rollout.py:29-69): see
:func:`filter_threshold`.
"""

from __future__ import annotations

import ctypes

import torch

from . import native
from .pooling import adaptive_avg_pool2d


def bisect_kth(flat: torch.Tensor, k: int, iters: int = 40) -> torch.Tensor:
    """The k-th smallest value of each row of ``flat`` (B, N) by ``iters``
    steps of value bisection seeded with the row min/max (the JAX package's
    XLA branch, rollout.py:147-157): exact for f32 up to ties."""
    lo = torch.amin(flat, dim=1)
    hi = torch.amax(flat, dim=1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = (flat <= mid[:, None]).sum(dim=1) < k
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return hi


def filter_threshold_plain(flat: torch.Tensor, k: int, iters: int = 40) -> torch.Tensor:
    """Zero the ``k`` smallest entries of each row of ``flat`` (B, N): every
    entry ``<=`` the bisected k-th smallest value becomes 0."""
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    return torch.where(flat <= bisect_kth(flat, k, iters)[:, None], zero, flat)


def filter_threshold(flat: torch.Tensor, k: int, iters: int = 40) -> torch.Tensor:
    """:func:`filter_threshold_plain`, as CUDA kernel K2 for a CUDA tensor.

    The output is bit-identical to the plain version: the kernel selects
    each row's k-th smallest value exactly (radix select on the floats'
    order-preserving integer images) and replays the bisection's ``iters``
    steps on it with the same f32 arithmetic.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (``filter_threshold.launches``
    counts the calls).
    """
    if flat.device.type == "cpu":
        return filter_threshold_plain(flat, k, iters)
    if flat.device.type != "cuda":
        raise ValueError(f"filter_threshold: unsupported device {flat.device}")
    if flat.dtype != torch.float32 or flat.ndim != 2 or not flat.is_contiguous():
        raise ValueError(
            "filter_threshold: expects a contiguous (B, N) float32 tensor, got "
            f"{tuple(flat.shape)} {flat.dtype}"
        )
    B, N = flat.shape
    if B > 65535:
        raise ValueError(f"filter_threshold: at most 65535 rows, got {B}")
    out = torch.empty_like(flat)
    words = native.launcher("filter_threshold", "filter_threshold_scratch_words", [])()
    # per row: the three digit histograms and the row's state, zeroed by the kernel
    scratch = torch.empty((B, words), dtype=torch.int32, device=flat.device)
    fn = native.launcher("filter_threshold", "filter_threshold_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    native.check(
        fn(flat.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, N, k, iters, stream),
        "filter_threshold",
    )
    filter_threshold.launches += 1
    return out


filter_threshold.launches = 0


def filter_attention_map(
    raw_attn: torch.Tensor,
    discard_ratio: float = 0.1,
    head_fusion: str = "min",
    compat_crossbatch: bool = False,
) -> torch.Tensor:
    """Head-fuse then zero the lowest ``discard_ratio`` of entries per map.

    Args:
      raw_attn: (B, heads, Tq, Tk) attention probabilities.
    Returns: (B, Tq, Tk).
    """
    if head_fusion == "mean":
        # sum * (1/n), the arithmetic of jnp.mean (bitwise, unlike torch.mean)
        fused = torch.sum(raw_attn, dim=1) * (1.0 / raw_attn.shape[1])
    elif head_fusion == "max":
        fused = torch.amax(raw_attn, dim=1)
    elif head_fusion == "min":
        fused = torch.amin(raw_attn, dim=1)
    else:
        raise ValueError(f"head fusion type not supported: {head_fusion}")

    # maps can be rectangular: q is unpooled, k/v are stride-2 pooled
    B, Tq, Tk = fused.shape
    k = int(Tq * Tk * discard_ratio)
    if k == 0:
        return fused
    flat = fused.reshape(B, Tq * Tk).float().contiguous()
    if flat.shape[1] <= 65536:
        # exact selection is cheap at this size (JAX: lax.top_k)
        kth = torch.kthvalue(flat, k, dim=1).values
    elif not compat_crossbatch:
        return filter_threshold(flat, k).reshape(B, Tq, Tk)
    else:
        kth = bisect_kth(flat, k)
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    drop = flat <= kth[:, None]
    if compat_crossbatch:
        # reference quirk: every sample is masked with the union of all
        # samples' discard sets
        drop = torch.any(drop, dim=0, keepdim=True)
    return torch.where(drop, zero, flat).reshape(B, Tq, Tk)


def resize_attn_map(attn: torch.Tensor, grid: int, has_cls: bool) -> torch.Tensor:
    """Pool a (B, Tq, Tk) token-token map to (B, grid^2, grid^2).

    Reference eval_cvt_diml.py:54-70: drop the cls row/col, pool the key axis
    spatially, transpose, pool the query axis, final transpose.
    """
    if has_cls:
        attn = attn[:, 1:, 1:]
    B, H, W = attn.shape
    s = int(round(W**0.5))
    new_size = grid * grid
    attn = attn.reshape(B, H, s, s)
    if s > grid:
        attn = adaptive_avg_pool2d(attn, grid)
    attn = attn.reshape(B, H, new_size).transpose(1, 2)
    sh = int(round(H**0.5))
    attn = attn.reshape(B, new_size, sh, sh)
    if sh > grid:
        attn = adaptive_avg_pool2d(attn, grid)
    return attn.reshape(B, new_size, new_size).transpose(1, 2)


def block_rollout_map(
    probs: torch.Tensor,
    grid: int,
    has_cls: bool,
    discard_ratio: float = 0.1,
    head_fusion: str = "min",
) -> torch.Tensor:
    """One block's contribution: filter + pool (called inside the forward)."""
    return resize_attn_map(
        filter_attention_map(probs, discard_ratio, head_fusion), grid, has_cls
    )


def attention_rollout(
    attn_mats: torch.Tensor, use_res: bool = True, keep_all_layers: bool = False
) -> torch.Tensor:
    """Joint attention via cumulative matmul over layers.

    Args:
      attn_mats: (L, B, G, G) per-block pooled maps (G = grid^2).
    Returns (B, G, G) final joint attention (or (L, B, G, G) if
    ``keep_all_layers``), matching eval_cvt_diml.py:132-140.
    """
    if use_res:
        G = attn_mats.shape[-1]
        attn_mats = attn_mats + torch.eye(G, dtype=attn_mats.dtype, device=attn_mats.device)
        attn_mats = attn_mats / torch.sum(attn_mats, dim=-1, keepdim=True)
    joint = attn_mats[0]
    joints = [joint]
    for A in attn_mats[1:]:
        joint = torch.matmul(A, joint)
        joints.append(joint)
    return torch.stack(joints) if keep_all_layers else joint


def rollout_saliency(attn_mats: torch.Tensor, use_res: bool = True) -> torch.Tensor:
    """Per-image saliency: final joint attention averaged over rows
    (reference eval_cvt_diml.py:255-256 `rollout[-1].mean(1)`).  (L,B,G,G) -> (B,G)."""
    return torch.mean(attention_rollout(attn_mats, use_res=use_res), dim=1)
