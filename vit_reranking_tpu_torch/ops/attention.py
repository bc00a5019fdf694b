"""KV-resident fused attention for CvT's shape regime, forward and backward.

Port of vit_reranking_tpu/ops/attention_pallas.py: ``softmax(q k^T * scale)
v`` for q (BH, T, D) and k, v (BH, Tkv, D), with scores and softmax in f32
and no (T, Tkv) probability tensor in device memory, in either direction.
Kernel K3 (``csrc/kv_attention.cu``) replaces the TPU kernels ``_fwd_kernel``
and ``_bwd_kernel`` (attention_pallas.py:48-111): see
:func:`kv_resident_attention`.  :func:`cvt_attention` is the (B, H, T, D)
entry point of models/cvt.py, with the JAX package's gate.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import native

# The JAX package's dispatch threshold on the score count T * Tkv, measured
# on a TPU v5e, where the kernel won at CvT-13 stage 0 (3136 x 784) and lost
# at stage 1 (784 x 196).  Kept as it is so that both packages route the
# same stages; it is not tuned for the H100.
KV_RESIDENT_MIN_SCORES = 500_000

# Head dims K3 is built for.  D = 256 does not fit the backward's shared
# memory (csrc/kv_attention.cu); cvt_attention returns None beyond 192, the
# one place where its routing differs from the JAX package's.
KERNEL_HEAD_DIMS = (64, 128, 192)


def kv_resident_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                scale: float) -> torch.Tensor:
    """The materialising version: f32 scores, softmax, then ``p @ v``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def _check_cuda(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.dtype != torch.float32 or t.ndim != 3 \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"kv_resident_attention: {name} must be a contiguous, 16-byte aligned 3-D "
                f"float32 CUDA tensor, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )


def _fwd_kernel(q, k, v, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_cuda(q=q, k=k, v=v)
    BH, T, D = q.shape
    Tkv = k.shape[1]
    if k.shape != (BH, Tkv, D) or v.shape != k.shape or D not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"kv_resident_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}; the kernel takes D in {KERNEL_HEAD_DIMS}"
        )
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    fn = native.launcher("kv_attention", "kv_attention_fwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    native.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                    BH, T, Tkv, D, scale, stream), "kv_attention_fwd")
    kv_resident_attention.fwd_launches += 1
    return o, lse


def _bwd_kernel(q, k, v, o, lse, do, scale):
    _check_cuda(do=do)
    if do.shape != q.shape:
        raise ValueError(f"kv_resident_attention: do {tuple(do.shape)} vs q {tuple(q.shape)}")
    BH, T, D = q.shape
    Tkv = k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty_like(lse)
    fn = native.launcher("kv_attention", "kv_attention_bwd", [
        *[ctypes.c_void_p] * 10, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    native.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), BH, T, Tkv, D, scale, stream), "kv_attention_bwd")
    kv_resident_attention.bwd_launches += 1
    return dq, dk, dv


class _KVResidentAttention(torch.autograd.Function):
    """Kernel K3 in both directions, on CUDA tensors only."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        o, lse = _fwd_kernel(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_kernel(q, k, v, o, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def kv_resident_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """softmax(q @ k^T * scale) @ v without probabilities in device memory,
    differentiable in q, k and v.

    q: (BH, T, D); k, v: (BH, Tkv, D).  On CPU tensors this is the plain
    version (:func:`kv_resident_attention_plain`), differentiated by
    autograd; on CUDA tensors the forward and the backward launch kernel K3
    (contiguous float32, D in ``KERNEL_HEAD_DIMS``, anything else raises).
    ``kv_resident_attention.fwd_launches`` / ``.bwd_launches`` count the
    launches.
    """
    if q.device.type == "cpu":
        return kv_resident_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"kv_resident_attention: unsupported device {q.device}")
    return _KVResidentAttention.apply(q, k, v, float(scale))


kv_resident_attention.fwd_launches = 0
kv_resident_attention.bwd_launches = 0


def cvt_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> Optional[torch.Tensor]:
    """(B, H, T, D) wrapper used by models/cvt.py: merges batch and heads and
    runs :func:`kv_resident_attention` when the shape qualifies (the JAX
    package's gate, attention_pallas.py:192-206, narrowed to the head dims
    the kernel is built for), else returns None and the caller materialises
    the probabilities."""
    B, H, T, D = q.shape
    Tkv = k.shape[2]
    if T % 8 or D % 64 or Tkv < 8 or D not in KERNEL_HEAD_DIMS:
        return None
    if T * Tkv < KV_RESIDENT_MIN_SCORES:
        return None
    out = kv_resident_attention(
        q.reshape(B * H, T, D).contiguous(), k.reshape(B * H, Tkv, D).contiguous(),
        v.reshape(B * H, Tkv, D).contiguous(), scale,
    )
    return out.reshape(B, H, T, D)
