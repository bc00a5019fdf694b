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
  * :func:`swin_attention`, the (Bw, H, T, D) dispatcher of models/swin.py.

On CUDA tensors both contracts launch the same window core in
``csrc/swin_attention.cu``, which solves each (T, T) window on its own: the
packed contract's products across windows are exactly zero after softmax
(-1e9 off the diagonal blocks), so the core reads only add's diagonal
blocks and writes zeros to the rest of its gradient.  On CPU tensors each
function is its plain version, differentiated by autograd.
"""

from __future__ import annotations

import ctypes
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

# blocks a launch aims for: each block owns one (window, head) and a run of
# images, so that small stages still fill the card's 132 SMs
TARGET_BLOCKS = 1056

_FWD_ARGS = [*[ctypes.c_void_p] * 6, *[ctypes.c_int] * 6, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_void_p]
_BWD_ARGS = [*[ctypes.c_void_p] * 11, *[ctypes.c_int] * 7, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_void_p]


def swin_window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                bias: torch.Tensor, mask: Optional[torch.Tensor],
                                scale: float) -> torch.Tensor:
    """The materialising batched version: f32 scores plus bias and mask,
    softmax, then ``p @ v`` (q/k/v (G, nW, T, D), G = H * B head slowest)."""
    B = q.shape[0] // bias.shape[0]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + bias.float().repeat_interleave(B, dim=0)[:, None]
    if mask is not None:
        s = s + mask.float()[None]
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def packed_attention_plain(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                           add: torch.Tensor, scale: float, B: int) -> torch.Tensor:
    """The full (P T, P T) packed function, as the JAX kernel computes it:
    qp/kp/vp (G, nblk, P T, D), add (H, nblk, P T, P T), G = H * B."""
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


def _check_cuda(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"swin attention: {name} must be a contiguous float32 CUDA tensor, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )


def _ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernel's vector loads
    of q, k, v and dO need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _runs(B: int, H: int, nW: int):
    """(images a block takes, blocks along the images) for a launch."""
    n = min(B, max(1, -(-TARGET_BLOCKS // (H * nW))))
    chunk = -(-B // n)
    return chunk, -(-B // chunk)


class _Launch:
    """One call's geometry: q/k/v (H * B, nW, T, D) and where the additive
    term of each (head, window) lies (see csrc/swin_attention.cu)."""

    def __init__(self, q, B, H, P, add_h, add_blk, lda, scale):
        G, nW, T, D = q.shape
        if G != H * B or not (2 <= T <= MAX_TOKENS) or D % 8 or D > MAX_HEAD_DIM:
            raise ValueError(
                f"swin attention: q {tuple(q.shape)} with H={H}, B={B}; the kernel takes "
                f"G = H * B, 2 <= T <= {MAX_TOKENS} and D a multiple of 8 up to {MAX_HEAD_DIM}"
            )
        self.chunk, self.runs = _runs(B, H, nW)
        self.dims = (B, H, nW, T, D, P, add_h, add_blk, lda)
        self.scale = float(scale)

    def forward(self, q, k, v, add, mask):
        o = torch.empty_like(q)
        fn = native.launcher("swin_attention", "swin_attention_fwd", _FWD_ARGS)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        native.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), add.data_ptr(),
                        0 if mask is None else mask.data_ptr(), o.data_ptr(), *self.dims,
                        self.chunk, self.runs, self.scale, stream), "swin_attention_fwd")
        return o

    def backward(self, q, k, v, add, mask, do, grad_add_shape, packed):
        B, H, nW, T = self.dims[:4]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        part = torch.empty((self.runs, H, nW, T, T), dtype=torch.float32, device=q.device)
        grad_add = torch.empty(grad_add_shape, dtype=torch.float32, device=q.device)
        fn = native.launcher("swin_attention", "swin_attention_bwd", _BWD_ARGS)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        native.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), add.data_ptr(),
                        0 if mask is None else mask.data_ptr(), do.data_ptr(), dq.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), part.data_ptr(), grad_add.data_ptr(),
                        int(packed), *self.dims, self.chunk, self.runs, self.scale, stream),
                     "swin_attention_bwd")
        return dq, dk, dv, grad_add


class _WindowAttention(torch.autograd.Function):
    """Kernel K4b in both directions, on CUDA tensors only."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale):
        _check_cuda(q=q, k=k, v=v, bias=bias, **({} if mask is None else {"mask": mask}))
        G, nW, T, _ = q.shape
        H = bias.shape[0]
        if k.shape != q.shape or v.shape != q.shape or G % H or bias.shape != (H, T, T) \
                or (mask is not None and mask.shape != (nW, T, T)):
            raise ValueError(
                f"swin_window_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                f"v {tuple(v.shape)}, bias {tuple(bias.shape)}, "
                f"mask {None if mask is None else tuple(mask.shape)}"
            )
        launch = _Launch(q, G // H, H, 1, T * T, 0, T, scale)
        o = launch.forward(q, k, v, bias, mask)
        swin_window_attention.fwd_launches += 1
        ctx.launch = launch
        ctx.save_for_backward(q, k, v, bias, mask)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask = ctx.saved_tensors
        dq, dk, dv, dbias = ctx.launch.backward(q, k, v, bias, mask, _ready(do),
                                                bias.shape, packed=False)
        swin_window_attention.bwd_launches += 1
        return dq, dk, dv, dbias, None, None


class _PackedAttention(torch.autograd.Function):
    """Kernel K4a in both directions, on CUDA tensors only."""

    @staticmethod
    def forward(ctx, qp, kp, vp, add, scale, B, T):
        _check_cuda(qp=qp, kp=kp, vp=vp, add=add)
        G, nblk, PT, D = qp.shape
        H = add.shape[0]
        if kp.shape != qp.shape or vp.shape != qp.shape or PT % T \
                or add.shape != (H, nblk, PT, PT):
            raise ValueError(
                f"_packed_attention: qp {tuple(qp.shape)}, kp {tuple(kp.shape)}, "
                f"vp {tuple(vp.shape)}, add {tuple(add.shape)}, T={T}"
            )
        P = PT // T
        launch = _Launch(qp.view(G, nblk * P, T, D), B, H, P, nblk * PT * PT, PT * PT, PT,
                         scale)
        o = launch.forward(qp, kp, vp, add, None)
        swin_window_attention_packed.fwd_launches += 1
        ctx.launch = launch
        ctx.save_for_backward(qp, kp, vp, add)
        return o

    @staticmethod
    def backward(ctx, do):
        qp, kp, vp, add = ctx.saved_tensors
        dq, dk, dv, dadd = ctx.launch.backward(qp, kp, vp, add, None, _ready(do),
                                               add.shape, packed=True)
        swin_window_attention_packed.bwd_launches += 1
        return dq, dk, dv, dadd, None, None, None


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
    kernel (float32, T <= 64, D a multiple of 8 up to 64; anything else
    raises).  ``.fwd_launches`` / ``.bwd_launches`` count the launches.
    """
    if q.device.type == "cpu":
        return swin_window_attention_plain(q, k, v, bias, mask, scale)
    _refuse(q.device, "swin_window_attention")
    return _WindowAttention.apply(
        _ready(q), _ready(k), _ready(v), bias.float().contiguous(),
        None if mask is None else mask.float().contiguous(), float(scale),
    )


swin_window_attention.fwd_launches = 0
swin_window_attention.bwd_launches = 0


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
    bias; ``.fwd_launches`` / ``.bwd_launches`` count the launches."""
    G, nW, T, D = q.shape
    B = G // bias.shape[0]
    P = _pick_pack_packed(nW, T)
    nblk = nW // P
    shape = (G, nblk, P * T, D)
    add = _packed_add_term(bias, mask, P, nblk)
    out = _packed_attention(q.reshape(shape), k.reshape(shape), v.reshape(shape), add,
                            scale, B, T)
    return out.reshape(G, nW, T, D)


swin_window_attention_packed.fwd_launches = 0
swin_window_attention_packed.bwd_launches = 0


def swin_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                   mask: Optional[torch.Tensor], scale: float,
                   n_windows: int = 1) -> Optional[torch.Tensor]:
    """(Bw, H, T, D) wrapper used by models/swin.py: Bw = B * nW window
    batches (window fastest, window_partition's order), H heads.  Reorders to
    the kernels' head-slowest (G, nW, T, D) layout and runs the packed or the
    batched contract (``SWIN_KERNEL_PACKED``) when the shape qualifies;
    returns None when it does not, and the caller materialises.

    bias: (H, T, T); mask: (nW, T, T) or None; n_windows: windows per image
    (mask.shape[0] when a mask is given)."""
    Bw, H, T, D = q.shape
    nW = mask.shape[0] if mask is not None else n_windows
    if Bw % nW or T != k.shape[2] or D % 8 or T < 2:
        return None
    if nW < SWIN_KERNEL_MIN_WINDOWS or T > MAX_TOKENS or D > MAX_HEAD_DIM:
        return None
    B = Bw // nW

    def to_kernel(t):
        # (B*nW, H, T, D) -> (H, B, nW, T, D) -> (H*B, nW, T, D)
        return t.reshape(B, nW, H, T, D).permute(2, 0, 1, 3, 4).reshape(H * B, nW, T, D)

    fn = swin_window_attention_packed if SWIN_KERNEL_PACKED else swin_window_attention
    out = fn(to_kernel(q), to_kernel(k), to_kernel(v), bias.float(),
             None if mask is None else mask.float(), scale)
    return out.reshape(H, B, nW, T, D).permute(1, 2, 0, 3, 4).reshape(Bw, H, T, D)
