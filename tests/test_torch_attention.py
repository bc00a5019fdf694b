"""The port's kv-resident attention (ops/attention.py: kernel K3's plain
version on the CPU, differentiated by autograd) against the JAX package's
Pallas kernel in interpret mode, at the shapes and tolerances of
tests/test_attention_pallas.py: forward to 2e-5 and dq/dk/dv to 5e-5 (f32
products and softmax summed in another order), plus the (B, H, T, D) gate
and CvTAttention's dispatch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vit_reranking_tpu.ops.attention_pallas as jax_ap
import vit_reranking_tpu_torch.ops.attention as ap
from vit_reranking_tpu_torch.models.cvt import CvTAttention

torch.set_num_threads(2)

SHAPES = [(392, 98, 64), (784, 196, 64), (64, 16, 64)]
IDS = ["stage0-like", "stage1", "tiny"]
SCALE = 64.0 ** -0.5


def _inputs(seed, BH, T, Tkv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, T, D)).astype(np.float32)
    k = rng.standard_normal((BH, Tkv, D)).astype(np.float32)
    v = rng.standard_normal((BH, Tkv, D)).astype(np.float32)
    w = rng.standard_normal((BH, T, D)).astype(np.float32)
    return q, k, v, w


@pytest.mark.parametrize("T,Tkv,D", SHAPES, ids=IDS)
def test_forward_matches_jax_kernel(T, Tkv, D):
    q, k, v, _ = _inputs(0, 3, T, Tkv, D)
    ref = jax_ap.kv_resident_attention(*map(jnp.asarray, (q, k, v)), SCALE, True)
    out = ap.kv_resident_attention(*map(torch.from_numpy, (q, k, v)), SCALE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("T,Tkv,D", SHAPES, ids=IDS)
def test_gradients_match_jax_kernel(T, Tkv, D):
    q, k, v, w = _inputs(1, 2, T, Tkv, D)

    def loss(q, k, v):
        return jnp.sum(jax_ap.kv_resident_attention(q, k, v, SCALE, True) * w)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = (ap.kv_resident_attention.fwd_launches, ap.kv_resident_attention.bwd_launches)
    torch.sum(ap.kv_resident_attention(tq, tk, tv, SCALE) * torch.from_numpy(w)).backward()
    for got, want, name in zip((tq.grad, tk.grad, tv.grad), ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, err_msg=name)
    # CPU tensors take the plain version: no kernel launch is counted
    assert (ap.kv_resident_attention.fwd_launches,
            ap.kv_resident_attention.bwd_launches) == before


def test_wrapper_refuses_other_devices():
    t = torch.zeros((1, 8, 64), device="meta")
    with pytest.raises(ValueError):
        ap.kv_resident_attention(t, t, t, 0.1)


def test_cvt_wrapper_dispatch(monkeypatch):
    """The gate of the JAX package's cvt_attention, case by case."""
    monkeypatch.setattr(ap, "KV_RESIDENT_MIN_SCORES", 0)
    monkeypatch.setattr(jax_ap, "KV_RESIDENT_MIN_SCORES", 0)
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 3, 64, 64), (2, 3, 16, 64), (2, 3, 16, 64)))
    ref = jax_ap.cvt_attention(*map(jnp.asarray, (q, k, v)), 0.1, interpret=True)
    out = ap.cvt_attention(*map(torch.from_numpy, (q, k, v)), 0.1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    # T not a multiple of 8 (197 with a cls token), D not a multiple of 64,
    # fewer than 8 keys -> None, in both packages
    for shapes in (((1, 1, 197, 64), (1, 1, 50, 64)), ((1, 1, 64, 32), (1, 1, 16, 32)),
                   ((1, 1, 64, 64), (1, 1, 4, 64))):
        qz, kz = np.zeros(shapes[0], np.float32), np.zeros(shapes[1], np.float32)
        assert jax_ap.cvt_attention(jnp.asarray(qz), jnp.asarray(kz), jnp.asarray(kz),
                                    0.1, interpret=True) is None
        assert ap.cvt_attention(torch.from_numpy(qz), torch.from_numpy(kz),
                                torch.from_numpy(kz), 0.1) is None
    # below the score-count threshold -> None; CvT-13 stage 0 at 224 px
    # (3136 x 784) passes it and stage 1 (784 x 196) does not
    monkeypatch.setattr(ap, "KV_RESIDENT_MIN_SCORES", 500_000)
    assert ap.cvt_attention(*map(torch.from_numpy, (q, k, v)), 0.1) is None
    assert 3136 * 784 >= ap.KV_RESIDENT_MIN_SCORES > 784 * 196


@pytest.mark.parametrize("with_cls,ret_attn,routed", [
    (False, False, True), (False, True, False), (True, False, False),
], ids=["cls-free", "ret_attn", "cls-token"])
def test_cvt_attention_module_dispatch(monkeypatch, with_cls, ret_attn, routed):
    """CvTAttention routes through cvt_attention only where the JAX package
    does (no cls token, not ret_attn), and both routes give the same output."""
    monkeypatch.setattr(ap, "KV_RESIDENT_MIN_SCORES", 0)
    calls = []
    real = ap.cvt_attention
    monkeypatch.setattr(ap, "cvt_attention", lambda *a: calls.append(1) or real(*a))
    torch.manual_seed(0)
    attn = CvTAttention(64, 1, True, 3, 1, 2, 1, 1, with_cls_token=with_cls).eval()
    x = torch.randn(2, 64 + with_cls, 64)
    with torch.no_grad():
        out, weights = attn(x, 8, 8, ret_attn=ret_attn)
        monkeypatch.setattr("vit_reranking_tpu_torch.models.cvt.USE_KV_RESIDENT_ATTENTION", False)
        ref, _ = attn(x, 8, 8, ret_attn=ret_attn)
    assert bool(calls) == routed
    assert (weights is None) == (not ret_attn)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """TF32 rounding of float32 values as cvt.rna does it: to nearest, ties
    away from zero, keeping 10 mantissa bits (add half of the dropped 13
    bits to the bit pattern, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of a float32 operand: its low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b from TF32 operands, summed in f32, as the tensor cores compute
    it: one product of the rounded operands (terms=1), or K3's split
    hi = tf32(x), lo = x - hi read truncated, and hi hi + hi lo + lo hi
    (terms=3).  Products of two TF32 values are exact in f32, so a float32
    matmul of the parts gives what the tensor cores give up to the order
    of the sum."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32_truncated(a - ah), _tf32_truncated(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


@pytest.mark.parametrize("terms,within", [(3, True), (1, False)], ids=["3xTF32", "1xTF32"])
def test_split_tf32_products_keep_k3_forward_tolerance(terms, within):
    """The precision argument behind K3's tensor-core products, on one head
    of CvT-13 stage 0 (T=3136, Tkv=784, D=64): the forward's two products
    in the 3-term split stay within the card check's K3 forward tolerance
    (1e-5) of the f32 plain version, and a single TF32 product does not."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32))
               for n in (3136, 784, 784))
    p = torch.softmax(_tf32_matmul(q, k.T, terms) * SCALE, dim=-1)
    out = _tf32_matmul(p, v, terms)
    ref = ap.kv_resident_attention_plain(q[None], k[None], v[None], SCALE)[0]
    err = float((out - ref).abs().max())
    assert (err <= 1e-5) == within, err
