"""Window-resident fused attention for Swin's windows, forward and backward.

Port of vit_reranking_tpu/ops/swin_attention_pallas.py, with its public
names and contracts: per window, ``softmax(q k^T * scale + bias[h] +
mask[w]) v``, with scores and softmax in f32 and no score or probability
tensor in device memory in either direction, differentiable in q, k, v and
the relative-position bias.

  * :func:`swin_window_attention`, the batched contract (kernel K4b):
    q/k/v (G, nW, T, D) with G = H * B, head slowest; bias (H, T, T);
    mask (nW, T, T) or None.
  * :func:`swin_window_attention_packed`, the packed contract (kernel K4a,
    the JAX package's default): P windows packed into one (P T, D) operand
    and one additive term ``add`` (H, nblk, P T, P T) from
    :func:`_packed_add_term`, whose gradient carries the bias gradient back.
  * :func:`swin_attention`, the (Bw, H, T, D) dispatcher, and
    :func:`swin_attention_qkv`, the entry models/swin.py calls, which takes
    the qkv projection's (Bw, T, 3C) output as it is and returns the
    (Bw, T, C) layout of ``proj``'s input.

Every entry takes float32 or bfloat16 q, k, v (the bias, mask and additive
term stay f32, and so does their gradient).  In bf16 the function is the TPU
kernels' arithmetic with bf16 operands: products summed in f32, scores,
softmax, dp and ds in f32, p (normalised) and ds rounded to bf16 before the
products they feed, each product's f32 sum scaled and rounded to bf16 once,
and the bias or additive-term gradient summed from the f32 ds.

On CUDA tensors every entry launches the same window core, in f32
``csrc/swin_attention.cu`` and in bf16 ``csrc/swin_attention_bf16.cu``,
which solves each (T, T) window on its own: the packed contract's products
across windows are exactly zero after softmax (-1e9 off the diagonal
blocks), so the core reads only add's diagonal blocks and writes zeros to
the rest of its gradient.  The core reads and writes its operands through
strides, so the qkv entry hands it the projection in place and gets back one
(Bw, T, 3C) gradient, with no copy of q, k, v, o or their gradients.  The
qkv entry launches the core with the batched geometry (bias and mask) for
either contract: the packed additive term's diagonal blocks are bias[h] +
mask[w] to the bit, so it is the same function, and no (H, nblk, P T, P T)
term is built on the card.  On CPU tensors each function is its plain
version, differentiated by autograd (the qkv entry's packed contract on
:func:`_packed_add_term`, as the JAX package computes it).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

from . import native

# dispatch gate: with nW < 4 (Swin-T stage 3: one 49-token window an image)
# the JAX package keeps the materialising path (swin_attention_pallas.py:384)
SWIN_KERNEL_MIN_WINDOWS = 4

# packed (block-diagonal) contract vs the batched one, as the JAX package
# reads it (swin_attention_pallas.py:391); SWIN_KERNEL_VARIANT=batched
# selects the batched one
SWIN_KERNEL_PACKED = os.environ.get("SWIN_KERNEL_VARIANT", "packed") != "batched"

# What the CUDA window core takes: a window padded to 64 rows and head dims
# that are multiples of 8 up to 64.  The JAX gate admits larger windows and
# heads; the dispatcher returns None for them (the caller materialises), the
# only place where routing differs from the JAX package's.
MAX_TOKENS = 64
MAX_HEAD_DIM = 64

# blocks a launch of the f32 core aims for: each block owns one (window,
# head) and a run of images, so that small stages still fill the card's 132
# SMs (the bf16 core's persistent blocks walk such units: _persistent_runs)
TARGET_BLOCKS = 1056

_FWD_ARGS = [*[ctypes.c_void_p] * 7, *[ctypes.c_int] * 6, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_void_p]
_BWD_ARGS = [*[ctypes.c_void_p] * 11, ctypes.c_int, ctypes.c_void_p, *[ctypes.c_int] * 6,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_void_p]


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of (bf16) operands with every product and sum in f32."""
    return torch.matmul(a.float(), b.float())


class _PlainBf16(torch.autograd.Function):
    """The plain version of either contract in bf16, with the TPU kernels'
    backward (swin_attention_pallas.py:88-115, :234-265): dp and ds in f32,
    ``dq = (ds k) scale``, ``dk = (ds^T q) scale`` and ``dv = p^T dO`` from
    ds and p rounded to bf16, each sum in f32 and rounded to bf16 once, and
    the additive term's gradient the f32 ds summed over the B images of each
    head (and, for the batched contract's bias, over the windows too).
    ``add`` is (H, nA, T', T') f32 with nA 1 or the operands' second dim;
    autograd of the forward would round dp to bf16, which the kernels do
    not."""

    @staticmethod
    def _probs(q, k, add, scale, B):
        H = add.shape[0]
        s = _f32_product(q, k.transpose(-1, -2)) * scale
        s = (s.view(H, B, *s.shape[1:]) + add[:, None]).view(s.shape)
        return torch.softmax(s, dim=-1)

    @staticmethod
    def forward(ctx, q, k, v, add, scale, B):
        ctx.scale, ctx.B = scale, B
        ctx.save_for_backward(q, k, v, add)
        p = _PlainBf16._probs(q, k, add, scale, B)
        return _f32_product(p.to(v.dtype), v).to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, add = ctx.saved_tensors
        scale, B = ctx.scale, ctx.B
        p = _PlainBf16._probs(q, k, add, scale, B)
        dp = _f32_product(do, v.transpose(-1, -2))
        ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
        ds16 = ds.to(q.dtype)
        dq = (_f32_product(ds16, k) * scale).to(q.dtype)
        dk = (_f32_product(ds16.transpose(-1, -2), q) * scale).to(k.dtype)
        dv = _f32_product(p.to(do.dtype).transpose(-1, -2), do).to(v.dtype)
        H = add.shape[0]
        dadd = ds.view(H, B, *ds.shape[1:]).sum(dim=1)
        if add.shape[1] == 1:
            dadd = dadd.sum(dim=1, keepdim=True)
        return dq, dk, dv, dadd.to(add.dtype), None, None


def swin_window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                bias: torch.Tensor, mask: Optional[torch.Tensor],
                                scale: float) -> torch.Tensor:
    """The materialising batched version: f32 scores plus bias and mask,
    softmax, then ``p @ v`` (q/k/v (G, nW, T, D), G = H * B head slowest);
    in bf16 with the TPU kernel's explicit backward (:class:`_PlainBf16`)."""
    B = q.shape[0] // bias.shape[0]
    if q.dtype == torch.bfloat16:
        # bias[h] + mask[w] as one (H, 1 or nW, T, T) f32 additive term;
        # autograd sums its gradient over the windows into the bias's
        add = bias.float()[:, None]
        if mask is not None:
            add = add + mask.float()[None]
        return _PlainBf16.apply(q, k, v, add, float(scale), B)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + bias.float().repeat_interleave(B, dim=0)[:, None]
    if mask is not None:
        s = s + mask.float()[None]
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def packed_attention_plain(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                           add: torch.Tensor, scale: float, B: int) -> torch.Tensor:
    """The full (P T, P T) packed function, as the JAX kernel computes it:
    qp/kp/vp (G, nblk, P T, D), add (H, nblk, P T, P T), G = H * B; in bf16
    with the TPU kernel's explicit backward (:class:`_PlainBf16`)."""
    if qp.dtype == torch.bfloat16:
        return _PlainBf16.apply(qp, kp, vp, add.float(), float(scale), B)
    s = torch.matmul(qp.float(), kp.float().transpose(-1, -2)) * scale
    s = s + add.float().repeat_interleave(B, dim=0)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(vp.dtype), vp).to(qp.dtype)


def _pick_pack_packed(nW: int, T: int, budget_bytes: int = 3 * 1024 * 1024) -> int:
    """Windows per packed block, as the JAX package picks them: the largest
    divisor of nW up to 16 whose padded (P T, P T) f32 block fits its
    budget.  It fixes the shape of the additive term."""
    best = 1
    for p in range(1, min(nW, 16) + 1):
        if nW % p == 0:
            lanes = -(-(p * T) // 128) * 128
            rows = -(-(p * T) // 8) * 8
            if rows * lanes * 4 <= budget_bytes:
                best = p
    return best


def _packed_add_term(bias: torch.Tensor, mask: Optional[torch.Tensor], P: int,
                     nblk: int) -> torch.Tensor:
    """(H, nblk, P T, P T) f32: block-diagonal bias + shift mask, -1e9 on the
    entries across windows (swin_attention_pallas.py:288-303)."""
    H, T, _ = bias.shape
    dev = bias.device
    eye = torch.eye(P, dtype=torch.float32, device=dev)
    ones = torch.ones((T, T), dtype=torch.float32, device=dev)
    off = (1.0 - torch.einsum("ts,pq->ptqs", ones, eye)).reshape(P * T, P * T) * -1e9
    big = torch.einsum("hts,pq->hptqs", bias.float(), eye).reshape(H, P * T, P * T) + off
    big = big[:, None].expand(H, nblk, P * T, P * T)
    if mask is not None:
        mb = mask.float().reshape(nblk, P, T, T)
        mbig = torch.einsum("npts,pq->nptqs", mb, eye).reshape(nblk, P * T, P * T)
        big = big + mbig[None]
    return big


_DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda(operands, **f32) -> None:
    """q, k, v (``operands``) contiguous CUDA tensors of one dtype, float32
    or bfloat16; the bias, mask or additive term (``f32``) contiguous
    float32 CUDA tensors."""
    dtypes = {t.dtype for t in operands.values()}
    for name, t in {**operands, **f32}.items():
        want = _DTYPES if name in operands else (torch.float32,)
        if t.device.type != "cuda" or t.dtype not in want or not t.is_contiguous() \
                or (name in operands and len(dtypes) != 1):
            raise ValueError(
                f"swin attention: {name} must be a contiguous CUDA tensor of "
                f"{' or '.join(str(d) for d in want)}"
                + (" (q, k and v of one dtype)" if name in operands else "")
                + f", got {tuple(t.shape)} {t.dtype} on {t.device}"
            )


def _ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernel's vector loads
    of q, k, v and dO need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _runs(B: int, H: int, nW: int):
    """(images a block takes, blocks along the images) for a launch of the
    f32 core."""
    n = min(B, max(1, -(-TARGET_BLOCKS // (H * nW))))
    chunk = -(-B // n)
    return chunk, -(-B // chunk)


@functools.lru_cache(maxsize=None)
def _persistent_runs(B: int, H: int, nW: int, slots: int):
    """(images a unit takes, runs of images) for the bf16 core, whose
    ``slots`` persistent blocks take the H nW runs units round robin: of the
    ways to cut B images into runs, the one that leaves the least work on
    the busiest block, counting a unit's own cost (its additive term read,
    its partial sum of ds written and reduced) as one image more, and of
    those the longest runs."""
    best = None
    for runs in range(1, B + 1):
        chunk = -(-B // runs)
        if -(-B // chunk) != runs:
            continue  # the same chunk as fewer runs
        key = (-(-(H * nW * runs) // slots) * (chunk + 1), -chunk)
        if best is None or key < best[0]:
            best = (key, chunk, runs)
    return best[1], best[2]


def _bf16_slots(D: int, backward: bool) -> int:
    """The blocks the bf16 core's forward or backward kernel for head dim D
    runs at once on the current card (the library works it out once a
    device and thread, and keeps it)."""
    fn = native.launcher("swin_attention_bf16", "swin_attention_bf16_slots",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = ctypes.c_int(0)
    native.check(fn(D, int(backward), ctypes.addressof(out)), "swin_attention_bf16_slots")
    return out.value


def _heads_slowest(t: torch.Tensor, H: int) -> torch.Tensor:
    """A (H * B, nW, T, D) contract tensor as the (B, nW, H, T, D) view the
    kernel's strides describe."""
    G, nW, T, D = t.shape
    return t.view(H, G // H, nW, T, D).permute(1, 2, 0, 3, 4)


def _qkv_views(qkv: torch.Tensor, nW: int, H: int):
    """q, k, v of a (B nW, T, 3 H D) projection as (B, nW, H, T, D) views
    of it, without a copy (the head dim stays contiguous)."""
    Bw, T, C3 = qkv.shape
    return qkv.view(Bw // nW, nW, T, 3, H, C3 // (3 * H)).permute(3, 0, 1, 4, 2, 5).unbind(0)


def _tokens_view(o: torch.Tensor, nW: int, H: int) -> torch.Tensor:
    """A (B nW, T, H D) attention output (or its gradient) as its
    (B, nW, H, T, D) view."""
    Bw, T, C = o.shape
    return o.view(Bw // nW, nW, T, H, C // H).permute(0, 1, 3, 2, 4)


def _strides(*groups):
    """The (image, window, head, token) strides of each group of (B, nW, H,
    T, D) views (one set a group, as the C entries take them, in elements);
    raises unless a group's views share their strides, the head dim is
    contiguous and every row starts on a 16-byte boundary (cp.async)."""
    per16 = 16 // groups[0][0].element_size()
    out = []
    for group in groups:
        t = group[0]
        if any(u.stride() != t.stride() for u in group):
            raise ValueError("swin attention: q, k and v (and their gradients) must share "
                             "their strides")
        if any(u.data_ptr() % 16 for u in group):
            raise ValueError("swin attention: operands must start on 16-byte boundaries")
        st = t.stride()
        if st[4] != 1 or any(x % per16 for x in st[:4]):
            raise ValueError(
                f"swin attention: operand with strides {st} at offset {t.storage_offset()}; "
                "the kernel reads and writes 16-byte aligned rows with a contiguous head dim"
            )
        out.extend(st[:4])
    return (ctypes.c_longlong * len(out))(*out)


def _entry(q: torch.Tensor, direction: str):
    """(library, C entry) of the core for q's dtype: ``csrc/swin_attention.cu``
    in f32, ``csrc/swin_attention_bf16.cu`` in bf16."""
    if q.dtype == torch.bfloat16:
        return "swin_attention_bf16", f"swin_attention_{direction}_bf16"
    return "swin_attention", f"swin_attention_{direction}"


def _count(fn, direction: str, dtype: torch.dtype) -> None:
    """One more launch on ``fn``'s counter for ``direction`` ("fwd"/"bwd")
    in ``dtype`` (``fwd_launches`` or ``fwd_bf16_launches``, ...)."""
    name = f"{direction}{'_bf16' if dtype == torch.bfloat16 else ''}_launches"
    setattr(fn, name, getattr(fn, name) + 1)


class _Launch:
    """One call's geometry: B images of nW windows, H heads, T tokens, D
    dims, and where the additive term of each (head, window) lies (see
    csrc/swin_attention.cu).  Operands are (B, nW, H, T, D) views."""

    def __init__(self, B, H, nW, T, D, P, add_h, add_blk, lda, scale):
        if not (2 <= T <= MAX_TOKENS) or D % 8 or not (0 < D <= MAX_HEAD_DIM):
            raise ValueError(
                f"swin attention: T={T}, D={D}; the kernel takes 2 <= T <= {MAX_TOKENS} "
                f"and D a multiple of 8 up to {MAX_HEAD_DIM}"
            )
        self.dims = (B, H, nW, T, D, P, add_h, add_blk, lda)
        self.scale = float(scale)

    def _runs(self, q, backward):
        """(chunk, runs) of the images for a launch in q's dtype."""
        B, H, nW, _, D = self.dims[:5]
        if q.dtype == torch.bfloat16:
            return _persistent_runs(B, H, nW, _bf16_slots(D, backward))
        return _runs(B, H, nW)

    def forward(self, q, k, v, add, mask, o):
        """o = attention(q, k, v), all (B, nW, H, T, D) views."""
        lib, symbol = _entry(q, "fwd")
        fn = native.launcher(lib, symbol, _FWD_ARGS)
        strides = _strides((q, k, v), (o,))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        native.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), add.data_ptr(),
                        0 if mask is None else mask.data_ptr(), o.data_ptr(), strides,
                        *self.dims, *self._runs(q, False), self.scale, stream), symbol)

    def backward(self, q, k, v, add, mask, do, dq, dk, dv, grad_add_shape, packed):
        """dq, dk, dv (views like q) from do; returns the gradient of the
        additive term, of ``grad_add_shape``."""
        B, H, nW, T = self.dims[:4]
        chunk, runs = self._runs(q, True)
        part = torch.empty((runs, H, nW, T, T), dtype=torch.float32, device=q.device)
        grad_add = torch.empty(grad_add_shape, dtype=torch.float32, device=q.device)
        lib, symbol = _entry(q, "bwd")
        fn = native.launcher(lib, symbol, _BWD_ARGS)
        strides = _strides((q, k, v), (do,), (dq, dk, dv))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        native.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), add.data_ptr(),
                        0 if mask is None else mask.data_ptr(), do.data_ptr(), dq.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), part.data_ptr(), grad_add.data_ptr(),
                        int(packed), strides, *self.dims, chunk, runs, self.scale, stream),
                     symbol)
        return grad_add


def _contract_launch(q, H, P, add_h, add_blk, lda, scale):
    G, nW, T, D = q.shape
    if G % H:
        raise ValueError(f"swin attention: q {tuple(q.shape)} with H={H}: G must be H * B")
    return _Launch(G // H, H, nW, T, D, P, add_h, add_blk, lda, scale)


def _contract_forward(launch, q, k, v, add, mask, H):
    o = torch.empty_like(q)
    launch.forward(*(_heads_slowest(t, H) for t in (q, k, v)), add, mask,
                   _heads_slowest(o, H))
    return o


def _contract_backward(launch, q, k, v, add, mask, do, H, packed):
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    grad_add = launch.backward(*(_heads_slowest(t, H) for t in (q, k, v)), add, mask,
                               *(_heads_slowest(t, H) for t in (do, dq, dk, dv)), add.shape,
                               packed)
    return dq, dk, dv, grad_add


class _WindowAttention(torch.autograd.Function):
    """Kernel K4b in both directions, on CUDA tensors only."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale):
        _check_cuda(dict(q=q, k=k, v=v), bias=bias, **({} if mask is None else {"mask": mask}))
        G, nW, T, _ = q.shape
        H = bias.shape[0]
        if k.shape != q.shape or v.shape != q.shape or G % H or bias.shape != (H, T, T) \
                or (mask is not None and mask.shape != (nW, T, T)):
            raise ValueError(
                f"swin_window_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                f"v {tuple(v.shape)}, bias {tuple(bias.shape)}, "
                f"mask {None if mask is None else tuple(mask.shape)}"
            )
        launch = _contract_launch(q, H, 1, T * T, 0, T, scale)
        o = _contract_forward(launch, q, k, v, bias, mask, H)
        _count(swin_window_attention, "fwd", q.dtype)
        ctx.launch = launch
        ctx.save_for_backward(q, k, v, bias, mask)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask = ctx.saved_tensors
        dq, dk, dv, dbias = _contract_backward(ctx.launch, q, k, v, bias, mask, _ready(do),
                                               bias.shape[0], packed=False)
        _count(swin_window_attention, "bwd", q.dtype)
        return dq, dk, dv, dbias, None, None


class _PackedAttention(torch.autograd.Function):
    """Kernel K4a in both directions, on CUDA tensors only."""

    @staticmethod
    def forward(ctx, qp, kp, vp, add, scale, B, T):
        _check_cuda(dict(qp=qp, kp=kp, vp=vp), add=add)
        G, nblk, PT, D = qp.shape
        H = add.shape[0]
        if kp.shape != qp.shape or vp.shape != qp.shape or PT % T \
                or add.shape != (H, nblk, PT, PT) or G != H * B:
            raise ValueError(
                f"_packed_attention: qp {tuple(qp.shape)}, kp {tuple(kp.shape)}, "
                f"vp {tuple(vp.shape)}, add {tuple(add.shape)}, B={B}, T={T}"
            )
        P = PT // T
        shape = (G, nblk * P, T, D)  # the packed layout is the batched one in memory
        launch = _contract_launch(qp.view(shape), H, P, nblk * PT * PT, PT * PT, PT, scale)
        o = _contract_forward(launch, qp.view(shape), kp.view(shape), vp.view(shape), add,
                              None, H)
        _count(swin_window_attention_packed, "fwd", qp.dtype)
        ctx.launch, ctx.shape = launch, shape
        ctx.save_for_backward(qp, kp, vp, add)
        return o.view(qp.shape)

    @staticmethod
    def backward(ctx, do):
        qp, kp, vp, add = ctx.saved_tensors
        shape = ctx.shape
        dq, dk, dv, dadd = _contract_backward(
            ctx.launch, qp.view(shape), kp.view(shape), vp.view(shape), add, None,
            _ready(do).view(shape), add.shape[0], packed=True)
        _count(swin_window_attention_packed, "bwd", qp.dtype)
        return dq.view(qp.shape), dk.view(qp.shape), dv.view(qp.shape), dadd, None, None, None


class _QkvAttention(torch.autograd.Function):
    """The window core reading q, k, v from the (B nW, T, 3 H D) projection
    in place and writing o as (B nW, T, H D), with the batched geometry
    (bias (H, T, T), mask (nW, T, T) or None) whichever contract ``counted``
    (the entry whose launch counters count it) names; the backward writes
    dq, dk, dv into one (B nW, T, 3 H D) gradient and returns dbias.  CUDA
    only."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, scale, H, nW, counted):
        Bw, T, C3 = qkv.shape
        C = C3 // 3
        launch = _Launch(Bw // nW, H, nW, T, C // H, 1, T * T, 0, T, scale)
        o = torch.empty((Bw, T, C), dtype=qkv.dtype, device=qkv.device)
        launch.forward(*_qkv_views(qkv, nW, H), bias, mask, _tokens_view(o, nW, H))
        _count(counted, "fwd", qkv.dtype)
        ctx.launch, ctx.H, ctx.nW, ctx.counted = launch, H, nW, counted
        ctx.save_for_backward(qkv, bias, mask)
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, bias, mask = ctx.saved_tensors
        H, nW = ctx.H, ctx.nW
        do_view = _tokens_view(_ready(do), nW, H)
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        dbias = ctx.launch.backward(*_qkv_views(qkv, nW, H), bias, mask, do_view,
                                    *_qkv_views(dqkv, nW, H), bias.shape, False)
        _count(ctx.counted, "bwd", qkv.dtype)
        return dqkv, dbias, None, None, None, None, None


def _refuse(device: torch.device, what: str) -> None:
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")


def swin_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, mask: Optional[torch.Tensor],
                          scale: float) -> torch.Tensor:
    """softmax(q k^T * scale + bias + mask) v per window, probabilities off
    device memory (kernel K4b).

    q/k/v: (G, nW, T, D) with G = H * B (head slowest: g // B = head);
    bias: (H, T, T); mask: (nW, T, T) or None.  Returns (G, nW, T, D).
    Differentiable in q, k, v and bias.  On CPU tensors this is
    :func:`swin_window_attention_plain`; on CUDA tensors it launches the
    kernel (q, k, v float32 or bfloat16, T <= 64, D a multiple of 8 up to
    64; anything else raises).  ``.fwd_launches`` / ``.bwd_launches`` count
    the float32 launches, ``.fwd_bf16_launches`` / ``.bwd_bf16_launches``
    the bfloat16 ones.
    """
    if q.device.type == "cpu":
        return swin_window_attention_plain(q, k, v, bias, mask, scale)
    _refuse(q.device, "swin_window_attention")
    return _WindowAttention.apply(
        _ready(q), _ready(k), _ready(v), bias.float().contiguous(),
        None if mask is None else mask.float().contiguous(), float(scale),
    )


swin_window_attention.fwd_launches = swin_window_attention.bwd_launches = 0
swin_window_attention.fwd_bf16_launches = swin_window_attention.bwd_bf16_launches = 0


def _packed_attention(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                      add: torch.Tensor, scale: float, B: int, T: int) -> torch.Tensor:
    """qp/kp/vp: (G, nblk, P T, D); add: (H, nblk, P T, P T) f32 with
    G = H * B and windows of T tokens.  Returns (G, nblk, P T, D),
    differentiable in qp, kp, vp and add.

    ``add`` must come from :func:`_packed_add_term`: on CUDA tensors the
    kernel reads only its diagonal (T, T) blocks, which is the same function
    because the -1e9 off them makes those probabilities exactly 0, and its
    gradient there exactly 0.  On CPU tensors this is
    :func:`packed_attention_plain` over the full (P T, P T) blocks."""
    if qp.device.type == "cpu":
        return packed_attention_plain(qp, kp, vp, add, scale, B)
    _refuse(qp.device, "_packed_attention")
    return _PackedAttention.apply(_ready(qp), _ready(kp), _ready(vp),
                                  add.float().contiguous(), float(scale), int(B), int(T))


def swin_window_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 bias: torch.Tensor, mask: Optional[torch.Tensor],
                                 scale: float) -> torch.Tensor:
    """Same contract as :func:`swin_window_attention`, via the packed
    block-diagonal contract (kernel K4a).  Differentiable in q, k, v and
    bias; the launches are counted as :func:`swin_window_attention`'s."""
    G, nW, T, D = q.shape
    B = G // bias.shape[0]
    P = _pick_pack_packed(nW, T)
    nblk = nW // P
    shape = (G, nblk, P * T, D)
    add = _packed_add_term(bias, mask, P, nblk)
    out = _packed_attention(q.reshape(shape), k.reshape(shape), v.reshape(shape), add,
                            scale, B, T)
    return out.reshape(G, nW, T, D)


swin_window_attention_packed.fwd_launches = swin_window_attention_packed.bwd_launches = 0
swin_window_attention_packed.fwd_bf16_launches = 0
swin_window_attention_packed.bwd_bf16_launches = 0


def _routed(Bw: int, nW: int, T: int, Tk: int, D: int) -> bool:
    """The dispatch gate of :func:`swin_attention` and
    :func:`swin_attention_qkv`: the JAX package's, narrowed to what the CUDA
    window core takes."""
    if Bw % nW or T != Tk or D % 8 or T < 2:
        return False
    return nW >= SWIN_KERNEL_MIN_WINDOWS and T <= MAX_TOKENS and D <= MAX_HEAD_DIM


def swin_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                   mask: Optional[torch.Tensor], scale: float,
                   n_windows: int = 1) -> Optional[torch.Tensor]:
    """(Bw, H, T, D) wrapper: Bw = B * nW window batches (window fastest,
    window_partition's order), H heads.  Reorders to the kernels'
    head-slowest (G, nW, T, D) layout and runs the packed or the batched
    contract (``SWIN_KERNEL_PACKED``) when the shape qualifies; returns None
    when it does not, and the caller materialises.

    bias: (H, T, T); mask: (nW, T, T) or None; n_windows: windows per image
    (mask.shape[0] when a mask is given)."""
    Bw, H, T, D = q.shape
    nW = mask.shape[0] if mask is not None else n_windows
    if not _routed(Bw, nW, T, k.shape[2], D):
        return None
    B = Bw // nW

    def to_kernel(t):
        # (B*nW, H, T, D) -> (H, B, nW, T, D) -> (H*B, nW, T, D)
        return t.reshape(B, nW, H, T, D).permute(2, 0, 1, 3, 4).reshape(H * B, nW, T, D)

    fn = swin_window_attention_packed if SWIN_KERNEL_PACKED else swin_window_attention
    out = fn(to_kernel(q), to_kernel(k), to_kernel(v), bias.float(),
             None if mask is None else mask.float(), scale)
    return out.reshape(H, B, nW, T, D).permute(1, 2, 0, 3, 4).reshape(Bw, H, T, D)


def swin_attention_qkv_plain(qkv: torch.Tensor, bias: torch.Tensor,
                             mask: Optional[torch.Tensor], scale: float, num_heads: int,
                             n_windows: int = 1) -> torch.Tensor:
    """The plain version of :func:`swin_attention_qkv`, on any device: the
    model's reshape and permute of qkv into q, k, v, :func:`swin_attention`'s
    head-slowest layout, and the plain version of the contract that
    ``SWIN_KERNEL_PACKED`` picks (autograd differentiates it)."""
    Bw, T, C3 = qkv.shape
    H = num_heads
    C = C3 // 3
    D = C // H
    nW = mask.shape[0] if mask is not None else n_windows
    B = Bw // nW
    # (B, nW, T, 3, H, D) -> (3, H, B, nW, T, D): q, k, v head slowest
    x = qkv.reshape(B, nW, T, 3, H, D).permute(3, 4, 0, 1, 2, 5).reshape(3, H * B, nW, T, D)
    bias = bias.float()
    mask = None if mask is None else mask.float()
    if SWIN_KERNEL_PACKED:
        P = _pick_pack_packed(nW, T)
        shape = (H * B, nW // P, P * T, D)
        out = packed_attention_plain(*(t.reshape(shape) for t in x),
                                     _packed_add_term(bias, mask, P, nW // P), scale, B)
    else:
        out = swin_window_attention_plain(x[0], x[1], x[2], bias, mask, scale)
    return out.reshape(H, B, nW, T, D).permute(1, 2, 3, 0, 4).reshape(Bw, T, C)


def swin_attention_qkv(qkv: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor],
                       scale: float, num_heads: int,
                       n_windows: int = 1) -> Optional[torch.Tensor]:
    """Window attention straight from the qkv projection, for models/swin.py.

    qkv: (Bw, T, 3 C), the projection's output (Bw = B * nW windows, window
    fastest; q, k, v in that order along the last dim, each H heads of
    D = C / H); bias (H, T, T); mask (nW, T, T) or None.  Returns (Bw, T, C),
    the heads side by side as ``proj`` takes them, or None where
    :func:`swin_attention` returns None (the caller materialises).
    Differentiable in qkv and bias.

    On CUDA tensors the kernel reads q, k and v in place and writes the
    output, and in the backward one (Bw, T, 3 C) gradient of qkv and dbias,
    with no copy of either (float32 or bfloat16, every row 16-byte aligned,
    else it raises).  It runs with bias and mask for either contract (the
    packed contract's function, without its (H, nblk, P T, P T) additive
    term), counted as K4a's or K4b's launches as ``SWIN_KERNEL_PACKED``
    picks.  On CPU tensors it is :func:`swin_attention_qkv_plain`."""
    Bw, T, C3 = qkv.shape
    H = num_heads
    if C3 % (3 * H):
        raise ValueError(f"swin_attention_qkv: qkv {tuple(qkv.shape)} with {H} heads")
    C = C3 // 3
    D = C // H
    nW = mask.shape[0] if mask is not None else n_windows
    if not _routed(Bw, nW, T, T, D):
        return None
    if qkv.device.type == "cpu":
        return swin_attention_qkv_plain(qkv, bias, mask, scale, H, n_windows=nW)
    _refuse(qkv.device, "swin_attention_qkv")
    if qkv.dtype not in _DTYPES:
        raise ValueError(
            f"swin_attention_qkv: qkv must be float32 or bfloat16, got {qkv.dtype}")
    # the counters name the TPU kernel that the setting runs in the JAX
    # package, whose function this launch computes
    counted = swin_window_attention_packed if SWIN_KERNEL_PACKED else swin_window_attention
    return _QkvAttention.apply(qkv, bias.float().contiguous(),
                               None if mask is None else mask.float().contiguous(),
                               float(scale), H, nW, counted)
