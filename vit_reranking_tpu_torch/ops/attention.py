"""KV-resident fused attention for CvT's shape regime, forward and backward.

Port of vit_reranking_tpu/ops/attention_pallas.py: ``softmax(q k^T * scale)
v`` for q (BH, T, D) and k, v (BH, Tkv, D), with scores and softmax in f32
and no (T, Tkv) probability tensor in device memory, in either direction.
Kernel K3 (``csrc/kv_attention.cu``) replaces the TPU kernels ``_fwd_kernel``
and ``_bwd_kernel`` (attention_pallas.py:48-111): see
:func:`kv_resident_attention`.  :func:`cvt_attention` is the (B, H, T, D)
entry point of models/cvt.py, with the JAX package's gate.

Both take float32 or bfloat16 q, k, v.  In bf16 the function is the TPU
kernel's arithmetic with bf16 operands: products summed in f32, scores,
softmax, lse and the backward's dp and ds in f32, p (normalised) and ds
rounded to bf16 before the products they feed, dK and dV summed in f32 over
every q row, and the output and gradients rounded to bf16 once.
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
# Head dims of K3's bf16 form (CvT-13's every stage has D = 64); for another
# head dim in bf16, cvt_attention returns None and the caller materialises.
KERNEL_HEAD_DIMS_BF16 = (64,)


def _head_dims(dtype: torch.dtype) -> Tuple[int, ...]:
    return KERNEL_HEAD_DIMS_BF16 if dtype == torch.bfloat16 else KERNEL_HEAD_DIMS


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of (bf16) operands with every product and sum in f32."""
    return torch.matmul(a.float(), b.float())


class _PlainBf16(torch.autograd.Function):
    """The plain version in bf16, with the TPU kernel's backward
    (attention_pallas.py:66-111): dp in f32, ``ds = p (dp - rowsum(dp p))
    scale`` in f32, p and ds rounded to bf16 before their products, every
    product summed in f32 and its result rounded to bf16 once.  Autograd of
    the forward would round dp to bf16, which the kernel does not."""

    @staticmethod
    def _probs(q, k, scale):
        return torch.softmax(_f32_product(q, k.transpose(-1, -2)) * scale, dim=-1)

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        p = _PlainBf16._probs(q, k, scale)
        return _f32_product(p.to(v.dtype), v).to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        p = _PlainBf16._probs(q, k, ctx.scale)
        dp = _f32_product(do, v.transpose(-1, -2))
        ds = (p * (dp - torch.sum(dp * p, dim=-1, keepdim=True)) * ctx.scale).to(q.dtype)
        dq = _f32_product(ds, k).to(q.dtype)
        dk = _f32_product(ds.transpose(-1, -2), q).to(k.dtype)
        dv = _f32_product(p.to(do.dtype).transpose(-1, -2), do).to(v.dtype)
        return dq, dk, dv, None


def kv_resident_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                scale: float) -> torch.Tensor:
    """The materialising version: f32 scores, softmax, then ``p @ v``; in
    f32 differentiated by autograd, in bf16 with the TPU kernel's explicit
    backward (:class:`_PlainBf16`)."""
    if q.dtype == torch.bfloat16:
        return _PlainBf16.apply(q, k, v, float(scale))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def _check_cuda(**tensors: torch.Tensor) -> None:
    dtypes = {t.dtype for t in tensors.values()}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.dtype not in (torch.float32, torch.bfloat16) \
                or len(dtypes) != 1 or t.ndim != 3 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(
                f"kv_resident_attention: {name} must be a contiguous, 16-byte aligned 3-D "
                f"float32 or bfloat16 CUDA tensor of the others' dtype, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )


def _suffix(dtype: torch.dtype) -> str:
    return "_bf16" if dtype == torch.bfloat16 else ""


def _fwd_kernel(q, k, v, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_cuda(q=q, k=k, v=v)
    BH, T, D = q.shape
    Tkv = k.shape[1]
    dims = _head_dims(q.dtype)
    if k.shape != (BH, Tkv, D) or v.shape != k.shape or D not in dims:
        raise ValueError(
            f"kv_resident_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}; the {q.dtype} kernel takes D in {dims}"
        )
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    name = "kv_attention_fwd" + _suffix(q.dtype)
    fn = native.launcher("kv_attention", name, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    native.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                    BH, T, Tkv, D, scale, stream), name)
    if q.dtype == torch.bfloat16:
        kv_resident_attention.fwd_bf16_launches += 1
    else:
        kv_resident_attention.fwd_launches += 1
    return o, lse


def _bwd_kernel(q, k, v, o, lse, do, scale):
    _check_cuda(q=q, do=do)
    if do.shape != q.shape:
        raise ValueError(f"kv_resident_attention: do {tuple(do.shape)} vs q {tuple(q.shape)}")
    BH, T, D = q.shape
    Tkv = k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty_like(lse)
    name = "kv_attention_bwd" + _suffix(q.dtype)
    fn = native.launcher("kv_attention", name, [
        *[ctypes.c_void_p] * 10, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    native.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), BH, T, Tkv, D, scale, stream), name)
    if q.dtype == torch.bfloat16:
        kv_resident_attention.bwd_bf16_launches += 1
    else:
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

    q: (BH, T, D); k, v: (BH, Tkv, D), all float32 or all bfloat16.  On CPU
    tensors this is the plain version (:func:`kv_resident_attention_plain`);
    on CUDA tensors the forward and the backward launch kernel K3
    (contiguous, D in ``KERNEL_HEAD_DIMS`` for float32 and
    ``KERNEL_HEAD_DIMS_BF16`` for bfloat16, anything else raises).
    ``kv_resident_attention.fwd_launches`` / ``.bwd_launches`` count the
    float32 launches, ``.fwd_bf16_launches`` / ``.bwd_bf16_launches`` the
    bfloat16 ones.
    """
    if q.device.type == "cpu":
        return kv_resident_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"kv_resident_attention: unsupported device {q.device}")
    return _KVResidentAttention.apply(q, k, v, float(scale))


kv_resident_attention.fwd_launches = 0
kv_resident_attention.bwd_launches = 0
kv_resident_attention.fwd_bf16_launches = 0
kv_resident_attention.bwd_bf16_launches = 0


def cvt_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> Optional[torch.Tensor]:
    """(B, H, T, D) wrapper used by models/cvt.py: merges batch and heads and
    runs :func:`kv_resident_attention` when the shape qualifies (the JAX
    package's gate, attention_pallas.py:192-206, narrowed to the head dims
    the kernel is built for in q's dtype), else returns None and the caller
    materialises the probabilities."""
    B, H, T, D = q.shape
    Tkv = k.shape[2]
    if T % 8 or D % 64 or Tkv < 8 or D not in _head_dims(q.dtype):
        return None
    if T * Tkv < KV_RESIDENT_MIN_SCORES:
        return None
    out = kv_resident_attention(
        q.reshape(B * H, T, D).contiguous(), k.reshape(B * H, Tkv, D).contiguous(),
        v.reshape(B * H, Tkv, D).contiguous(), scale,
    )
    return out.reshape(B, H, T, D)
