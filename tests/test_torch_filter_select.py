"""The identity kernel K2 (``csrc/filter_threshold.cu``) rests on, held on
the CPU: the exact k-th smallest value of a row by radix digits (11, 11 and
10 bits) on the floats' order-preserving integer image, then the 40 steps of
value bisection replayed on scalars (lo = mid exactly when mid < v_k), give
the threshold of ``ops/rollout.py::bisect_kth`` and the output of
``filter_threshold_plain`` bit for bit.

The emulation below is numpy, written from the kernel's arithmetic; the
bisection is the port's (torch) and, once, the JAX package's XLA branch.
Thresholds compare as floats (-0.0 == +0.0: a row with zeros of both signs
may leave either, and both zero the same entries); outputs compare as bits.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from vit_reranking_tpu.ops.rollout import filter_attention_map as jax_filter_attention_map
from vit_reranking_tpu_torch.ops.rollout import bisect_kth, filter_threshold_plain

torch.set_num_threads(2)

DIGITS = ((11, 21), (11, 10), (10, 0))  # (bits, shift) of each radix pass


def _keys(x):
    """Order-preserving uint32 image of f32 values (the kernel's key_of)."""
    u = x.view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _floats(k):
    k = np.asarray(k, dtype=np.uint32)
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32).view(np.float32)


def _radix_kth(row, k):
    """The k-th smallest entry of ``row`` (1 <= k <= N) by three counting
    passes, each over the entries whose higher digits match the prefix."""
    key = _keys(row)
    prefix, rank = 0, k
    for p, (bits, shift) in enumerate(DIGITS):
        sel = key if p == 0 else key[(key >> (shift + bits)) == prefix]
        hist = np.bincount((sel >> shift) & ((1 << bits) - 1), minlength=1 << bits)
        cum = np.cumsum(hist)
        d = int(np.searchsorted(cum, rank))  # first bucket whose running count reaches rank
        rank -= int(cum[d] - hist[d])
        prefix = (prefix << bits) | d
    return _floats(prefix)


def _select_and_replay(flat, k, iters=40):
    """The kernel's threshold for each row of ``flat`` (B, N) f32."""
    B, N = flat.shape
    out = np.empty(B, dtype=np.float32)
    half = np.float32(0.5)
    for b in range(B):
        key = _keys(flat[b])
        lo, hi = _floats(key.min()), _floats(key.max())
        vk = _radix_kth(flat[b], min(max(k, 1), N))
        for _ in range(iters):
            mid = half * (lo + hi)
            below = True if k > N else (False if k < 1 else bool(mid < vk))
            lo, hi = (mid, hi) if below else (lo, mid)
        out[b] = hi
    return out


def _check(flat, k):
    hi = _select_and_replay(flat, k)
    t = torch.from_numpy(flat)
    ref = bisect_kth(t, k).numpy()
    assert np.array_equal(hi, ref), (hi, ref)
    out = np.where(flat <= hi[:, None], np.float32(0.0), flat)
    plain = filter_threshold_plain(t, k).numpy()
    assert np.array_equal(out.view(np.uint32), plain.view(np.uint32))


def _row(kind, rng, n):
    if kind == "softmax":
        z = rng.standard_normal(n)
        e = np.exp(z - z.max())
        return (e / e.sum()).astype(np.float32)
    if kind == "ties":  # a few distinct values, each repeated many times
        return rng.choice(np.array([0.0, 1e-3, 2.5e-3, 0.5, 1e-3], np.float32), n)
    if kind == "signed_zeros":  # +0.0 and -0.0 mixed with small values of both signs
        vals = np.array([0.0, -0.0, 1e-30, -1e-30, 3e-4, -3e-4], np.float32)
        return rng.choice(vals, n)
    if kind == "constant":
        return np.full(n, np.float32(rng.standard_normal()), np.float32)
    if kind == "normal":  # both signs, wide exponents
        return (rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    raise ValueError(kind)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    kind=st.sampled_from(["softmax", "ties", "signed_zeros", "constant", "normal"]),
    n=st.integers(2, 5000),
    which_k=st.sampled_from(["one", "tenth", "all"]),
    seed=st.integers(0, 2**32 - 1),
)
def test_select_and_replay_matches_bisection(kind, n, which_k, seed):
    rng = np.random.default_rng(seed)
    flat = np.stack([_row(kind, rng, n) for _ in range(2)])
    k = {"one": 1, "tenth": n // 10, "all": n}[which_k]
    _check(flat, k)


@pytest.mark.parametrize("k", [0, 1, 5, 9, 10, 11])
def test_select_and_replay_at_the_edges_of_k(k):
    """k from 0 (the bisection never moves lo) to past N (never moves hi)."""
    rng = np.random.default_rng(3)
    _check(np.stack([_row("softmax", rng, 10), _row("ties", rng, 10)]), k)


def test_select_and_replay_matches_jax_bisection_branch():
    """At N > 65536 the JAX package's filter_attention_map takes its XLA
    bisection on the CPU; the emulated kernel's output is the same bits."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, 300, 256)).astype(np.float32)
    x = np.exp(x - x.max(-1, keepdims=True))
    raw = (x / x.sum(-1, keepdims=True)).astype(np.float32)
    ref = np.asarray(jax_filter_attention_map(jnp.asarray(raw), head_fusion="min"))
    flat = raw.reshape(2, -1)
    k = int(flat.shape[1] * 0.1)
    hi = _select_and_replay(flat, k)
    out = np.where(flat <= hi[:, None], np.float32(0.0), flat).reshape(ref.shape)
    assert np.array_equal(out.view(np.uint32), ref.view(np.uint32))
    assert ((out == 0).reshape(2, -1).sum(1) == k).all()
