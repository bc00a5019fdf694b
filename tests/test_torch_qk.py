"""The port's qk rerank method (the ViT attention-map OT cost, kernel K1's
mode (d)) against the JAX package's, on the same numpy inputs.

JAX runs its Pallas kernel in interpret mode on the CPU; the port runs the
plain PyTorch version of its CUDA kernel (the wrapper takes it for CPU
tensors).  Tolerance 1e-5 absolute on O(1) scores, with identical rankings:
the two sides sum the mat-vecs of each Sinkhorn step and the q.k products
in other orders, and the exit decisions (a residual against 0.1) come out
the same.  The bf16 stream is held to the JAX package's own bf16 bound
(3e-3, tests/test_rerank_pallas.py:448) against the f32 path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vit_reranking_tpu.ops.rerank_pallas import (
    _pack_pairs,
    fused_qk_rerank_scores as jax_fused_qk_rerank_scores,
    sinkhorn_scores_packed,
)
from vit_reranking_tpu.ops.similarity import calc_similarity_qk as jax_calc_similarity_qk
from vit_reranking_tpu_torch.ops.rerank import fused_qk_rerank_scores, sinkhorn_scores_plain
from vit_reranking_tpu_torch.ops.similarity import calc_similarity_qk

torch.set_num_threads(2)

TOL = 1e-5
# the flag sets of tests/test_rerank_pallas.py::test_fused_qk_matches_xla
FLAGS = [dict(scale=1.0 / 8.0), dict(scale=1.0),
         dict(scale=1.0 / 8.0, use_exp=True, temperature=0.5),
         dict(scale=1.0, use_uniform=True)]
FLAG_IDS = ["vit-scale", "cvt-scale", "exp", "uniform"]


def _problem(seed, N=16, K=8, C=24, R=49, H=3, D=16):
    rng = np.random.default_rng(seed)
    fb = rng.standard_normal((N, C, R)).astype(np.float32)
    fb /= np.linalg.norm(fb, axis=1, keepdims=True)
    centers = fb.mean(-1)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    q = rng.standard_normal((N, H, R + 1, D)).astype(np.float32)
    k = rng.standard_normal((N, H, R + 1, D)).astype(np.float32)
    sims = centers @ centers.T
    np.fill_diagonal(sims, -100)
    top = np.argsort(-sims, 1, kind="stable")[:, :K].astype(np.int32)
    return fb, centers, q, k, top


def _same_order(a, b):
    return np.array_equal(np.argsort(-a, 1, kind="stable"), np.argsort(-b, 1, kind="stable"))


@pytest.mark.parametrize("flags", FLAGS + [dict(scale=1.0 / 8.0, use_ot=False)],
                         ids=FLAG_IDS + ["dual-softmax"])
def test_calc_similarity_qk_matches_jax(flags):
    """The eager path, one query against its K candidates and a tile of
    queries at once (the port's leading axis, JAX's vmap)."""
    fb, centers, q, k, top = _problem(0)
    ref = np.stack([np.asarray(jax_calc_similarity_qk(
        centers[i], fb[i], q[i], centers[top[i]], fb[top[i]], k[top[i]], stage=1, **flags
    )[0]) for i in range(len(fb))])
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    one = np.stack([calc_similarity_qk(
        t(centers[i]), t(fb[i]), t(q[i]), t(centers[top[i]]), t(fb[top[i]]), t(k[top[i]]),
        stage=1, **flags)[0].numpy() for i in range(len(fb))])
    tile, aux = calc_similarity_qk(t(centers), t(fb), t(q), t(centers[top]), t(fb[top]),
                                   t(k[top]), stage=1, **flags)
    assert tile.shape == ref.shape and aux.T.shape == (16, 8, 49, 49)
    np.testing.assert_allclose(one, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(tile.numpy(), ref, rtol=0, atol=TOL)
    assert _same_order(tile.numpy(), ref)


def test_calc_similarity_qk_stage0_is_global():
    fb, centers, q, k, top = _problem(1)
    sim, aux = calc_similarity_qk(*(torch.from_numpy(x) for x in (
        centers[0], fb[0], q[0], centers[top[0]], fb[top[0]], k[top[0]])), stage=0)
    assert aux is None
    np.testing.assert_allclose(sim.numpy(), centers[top[0]] @ centers[0], atol=1e-6)


@pytest.mark.parametrize("ot_part", [1.0, 0.5], ids=["full", "partial-0.5"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_cost_mode_matches_jax_kernel(ot_part, dtype):
    """sinkhorn_scores_plain(cost=C) against the TPU kernel's has_cost mode
    (sinkhorn_scores_packed(C_packed=...)) on 100 pairs whose OT kernel
    comes from C while the score contracts against S."""
    rng = np.random.default_rng(2)
    P, R = 100, 49
    S = np.tanh(rng.standard_normal((P, R, R))).astype(np.float32) * 0.3
    C = (0.2 * rng.standard_normal((P, R, R))).astype(np.float32)
    u = rng.dirichlet(np.ones(R), P).astype(np.float32)
    v = rng.dirichlet(np.ones(R), P).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    pack = lambda x, dt=jnp.float32: _pack_pairs(jnp.asarray(x).astype(dt), 128)
    ref = np.asarray(sinkhorn_scores_packed(
        pack(S, jdt), pack(u), pack(v), C_packed=pack(C, jdt), ot_part=ot_part, interpret=True,
    )).reshape(-1)[:P]
    tdt = getattr(torch, dtype)
    out = sinkhorn_scores_plain(
        torch.from_numpy(S).to(tdt), torch.from_numpy(u), torch.from_numpy(v), ot_part=ot_part,
        cost=torch.from_numpy(C).to(tdt))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)
    # the cost changes the answer: S's own kernel gives other scores
    own = sinkhorn_scores_plain(torch.from_numpy(S).to(tdt), torch.from_numpy(u),
                                torch.from_numpy(v), ot_part=ot_part)
    assert float((own - out).abs().max()) > 1e-3


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_fused_qk_matches_jax(flags):
    fb, centers, q, k, top = _problem(3)
    ref = np.asarray(jax_fused_qk_rerank_scores(
        *map(jnp.asarray, (fb, q, k, top)), query_tile=8, interpret=True, **flags))
    out = fused_qk_rerank_scores(
        *map(torch.from_numpy, (fb, q, k, top.astype(np.int64))), query_tile=8, **flags
    ).numpy()
    assert out.shape == ref.shape == (16, 8)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    assert _same_order(out, ref)


def test_fused_qk_refuses_a_grid_that_is_not_the_token_grid():
    fb, centers, q, k, top = _problem(4)
    with pytest.raises(ValueError, match="tokens"):
        fused_qk_rerank_scores(*map(torch.from_numpy, (fb[:, :, :36], q, k, top.astype(np.int64))))


def test_bf16_stream_close_to_f32():
    """bf16 S and cost against the JAX f32 path, at the bound of the JAX
    package's own bf16-stream test."""
    fb, centers, q, k, top = _problem(5)
    ref = np.asarray(jax_fused_qk_rerank_scores(
        *map(jnp.asarray, (fb, q, k, top)), query_tile=8, interpret=True))
    out16 = fused_qk_rerank_scores(
        *map(torch.from_numpy, (fb, q, k, top.astype(np.int64))), query_tile=8,
        stream_dtype="bfloat16").numpy()
    assert np.abs(out16 - ref).max() < 3e-3
