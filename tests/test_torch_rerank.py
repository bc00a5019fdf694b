"""The port's fused rollout rerank (the code around kernel K1) against the JAX
package's, on the same numpy inputs.

JAX runs its Pallas kernel in interpret mode on the CPU; the port runs the
plain PyTorch version of its CUDA kernel (the wrapper takes it for CPU
tensors).  Score tolerance 1e-5 absolute: the scores are O(1) sums of 49^2
terms, and the two sides add the 49-term mat-vecs of each Sinkhorn step in
different orders; the exit decisions (a residual against 0.1) come out the
same, so the reranked order must be identical.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vit_reranking_tpu.ops.rerank_pallas import (
    fused_rerank_tile as jax_fused_rerank_tile,
    fused_rollout_rerank_scores as jax_fused_rollout_rerank_scores,
)
from vit_reranking_tpu_torch.ops.rerank import (
    PAIR_CHUNK,
    fused_rerank_tile,
    fused_rollout_rerank_scores,
    rollout_marginals,
)

torch.set_num_threads(2)

TOL = 1e-5


def _problem(seed, N, K, C=32, R=49):
    rng = np.random.default_rng(seed)
    fb = rng.standard_normal((N, C, R)).astype(np.float32)
    fb /= np.linalg.norm(fb, axis=1, keepdims=True)
    centers = fb.mean(-1)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    roll = np.abs(rng.standard_normal((N, R))).astype(np.float32)
    sims = centers @ centers.T
    np.fill_diagonal(sims, -100)
    top = np.argsort(-sims, 1, kind="stable")[:, :K].astype(np.int32)
    return fb, centers, roll, top


def _both(fb, centers, roll, top, **kw):
    ref = np.asarray(jax_fused_rollout_rerank_scores(
        *map(jnp.asarray, (fb, centers, roll, top)), query_tile=16, interpret=True, **kw
    ))
    out = fused_rollout_rerank_scores(
        *map(torch.from_numpy, (fb, roll, top.astype(np.int64))), query_tile=16, **kw,
    ).numpy()
    return ref, out


def _same_order(a, b):
    return np.array_equal(np.argsort(-a, 1, kind="stable"), np.argsort(-b, 1, kind="stable"))


@pytest.mark.parametrize("K", [16, 100])
@pytest.mark.parametrize(
    "ot_part", [1.0, 0.5, 0.8, 0.9], ids=["full", "partial-0.5", "partial-0.8", "partial-0.9"]
)
def test_fused_rollout_matches_jax(K, ot_part):
    fb, centers, roll, top = _problem(0, N=K + 8, K=K)
    ref, out = _both(fb, centers, roll, top, ot_part=ot_part)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    assert _same_order(out, ref)


def test_fused_rollout_uniform_matches_jax():
    fb, centers, roll, top = _problem(1, N=24, K=16)
    ref, out = _both(fb, centers, roll, top, use_uniform=True)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    assert _same_order(out, ref)


def test_wide_k_chunked_group_exit_matches_jax():
    """K > 128 under partial OT: each query's candidates exit per wrap-padded
    128-pair chunk, the JAX kernel's rule (rerank_pallas.py:441-456)."""
    rng = np.random.default_rng(2)
    T, K, C, R = 2, PAIR_CHUNK + 6, 16, 49
    an = rng.standard_normal((T, C, R)).astype(np.float32)
    an /= np.linalg.norm(an, axis=1, keepdims=True)
    fb = rng.standard_normal((T, K, C, R)).astype(np.float32)
    fb /= np.linalg.norm(fb, axis=2, keepdims=True)
    rq = np.abs(rng.standard_normal((T, R))).astype(np.float32)
    rg = np.abs(rng.standard_normal((T, K, R))).astype(np.float32)
    u, v = (t.numpy() for t in rollout_marginals(torch.from_numpy(rq), torch.from_numpy(rg)))
    ref = np.asarray(jax_fused_rerank_tile(
        *map(jnp.asarray, (an, fb, u, v)), ot_part=0.5, interpret=True
    ))
    out = fused_rerank_tile(*map(torch.from_numpy, (an, fb, u, v)), ot_part=0.5).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    assert _same_order(out, ref)


@pytest.mark.parametrize("ot_part", [1.0, 0.5], ids=["full", "partial-0.5"])
def test_bf16_stream_close_to_f32(ot_part):
    """bf16 S against the JAX f32 path, at the bound of the JAX package's own
    test_bf16_stream_close_to_f32 (tests/test_rerank_pallas.py:448): S in
    [-1, 1] rounds to bf16 (2^-8 ulp) and the plan renormalizes."""
    fb, centers, roll, top = _problem(3, N=16, K=8)
    ref, _ = _both(fb, centers, roll, top, ot_part=ot_part)
    _, out16 = _both(fb, centers, roll, top, ot_part=ot_part, stream_dtype="bfloat16")
    assert np.abs(out16 - ref).max() < 3e-3
