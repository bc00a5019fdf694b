"""The port's Sinkhorn OT and rollout similarity against the JAX package's,
on the same numpy inputs.

Plans agree to 1e-6 absolute (entries of a plan of total mass ~1; the two
sides add the mat-vecs in different orders) and to the numpy loop oracle of
tests/test_sinkhorn.py, including the early-exit freeze.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vit_reranking_tpu.ops.similarity import (
    calc_similarity_rollout as jax_calc_similarity_rollout,
)
from vit_reranking_tpu.ops.sinkhorn import (
    sinkhorn as jax_sinkhorn,
    sinkhorn_partial as jax_sinkhorn_partial,
    sinkhorn_plan_from_scores as jax_plan_from_scores,
)
from vit_reranking_tpu_torch.ops.similarity import calc_similarity_rollout, l2_normalize
from vit_reranking_tpu_torch.ops.sinkhorn import (
    sinkhorn,
    sinkhorn_partial,
    sinkhorn_plan_from_scores,
)

torch.set_num_threads(2)

ATOL = 1e-6


def np_sinkhorn(K, u, v, iters=100, thresh=1e-1):
    """Oracle: plain numpy loop with the reference's early-break rule."""
    r = np.ones_like(u)
    c = np.ones_like(v)
    for _ in range(iters):
        r0 = r
        r = u / np.einsum("...mn,...n->...m", K, c)
        c = v / np.einsum("...mn,...m->...n", K, r)
        if np.mean(np.abs(r - r0)) < thresh:
            break
    return r[..., :, None] * K * c[..., None, :]


def rand_problem(rng, b=4, m=7, n=7):
    S = rng.uniform(-1, 1, (b, m, n)).astype(np.float32)
    K = np.exp(-(1 - S) / 0.05).astype(np.float32)
    u = rng.uniform(0.1, 1.0, (b, m)).astype(np.float32)
    v = rng.uniform(0.1, 1.0, (b, n)).astype(np.float32)
    u /= u.sum(-1, keepdims=True)
    v /= v.sum(-1, keepdims=True)
    return K, u, v


@pytest.mark.parametrize("thresh", [1e-1, 0.5, 0.0], ids=["default", "early-exit", "no-exit"])
def test_sinkhorn_matches_jax_and_oracle(thresh):
    rng = np.random.default_rng(0)
    K, u, v = rand_problem(rng, b=3, m=49, n=49)
    ref = np.asarray(jax_sinkhorn(*map(jnp.asarray, (K, u, v)), thresh=thresh))
    out = sinkhorn(*map(torch.from_numpy, (K, u, v)), thresh=thresh).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=ATOL)
    np.testing.assert_allclose(out, np_sinkhorn(K, u, v, thresh=thresh), rtol=1e-4, atol=ATOL)


def test_early_exit_freeze_matches_break():
    # the case of tests/test_sinkhorn.py: a loose threshold breaks the oracle
    # after few iterations, and the freeze must land on the same plan
    rng = np.random.default_rng(1)
    K, u, v = rand_problem(rng, b=2)
    out = sinkhorn(*map(torch.from_numpy, (K, u, v)), thresh=0.5).numpy()
    np.testing.assert_allclose(out, np_sinkhorn(K, u, v, thresh=0.5), rtol=1e-4, atol=ATOL)
    ref = np.asarray(jax_sinkhorn(*map(jnp.asarray, (K, u, v)), thresh=0.5))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=ATOL)


@pytest.mark.parametrize("ot_part", [0.5, 0.8])
def test_sinkhorn_partial_matches_jax(ot_part):
    rng = np.random.default_rng(2)
    K, u, v = rand_problem(rng, b=3, m=49, n=49)
    ref = np.asarray(jax_sinkhorn_partial(*map(jnp.asarray, (K, u, v)), ot_part=ot_part))
    out = sinkhorn_partial(*map(torch.from_numpy, (K, u, v)), ot_part=ot_part).numpy()
    assert out.shape == (3, 50, 50)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=ATOL)


def test_batch_dims_match_vmap():
    """batch_dims=1 gives each leading problem its own exit, like vmap."""
    rng = np.random.default_rng(3)
    K, u, v = rand_problem(rng, b=6, m=9, n=9)
    K, u, v = K.reshape(2, 3, 9, 9), u.reshape(2, 3, 9), v.reshape(2, 3, 9)
    ref = np.asarray(jax.vmap(jax_sinkhorn)(*map(jnp.asarray, (K, u, v))))
    out = sinkhorn(*map(torch.from_numpy, (K, u, v)), batch_dims=1).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=ATOL)


@pytest.mark.parametrize("ot_part", [1.0, 0.5])
def test_plan_from_scores_matches_jax(ot_part):
    rng = np.random.default_rng(4)
    S = rng.uniform(-0.5, 0.5, (2, 9, 9)).astype(np.float32)
    u = np.full((2, 9), 1 / 9, np.float32)
    ref = jax_plan_from_scores(jnp.asarray(S), jnp.asarray(u), jnp.asarray(u), ot_part=ot_part)
    out = sinkhorn_plan_from_scores(torch.from_numpy(S), torch.from_numpy(u),
                                    torch.from_numpy(u), ot_part=ot_part)
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=ATOL)


@pytest.mark.parametrize("ot_part", [1.0, 0.5])
@pytest.mark.parametrize("use_uniform", [False, True], ids=["rollout", "uniform"])
def test_calc_similarity_rollout_matches_jax(ot_part, use_uniform):
    rng = np.random.default_rng(5)
    Q, N, C, R = 3, 10, 32, 49
    fb = rng.standard_normal((N, C, R)).astype(np.float32)
    fb /= np.linalg.norm(fb, axis=1, keepdims=True)
    an = fb[:Q] + 0.1 * rng.standard_normal((Q, C, R)).astype(np.float32)
    centers = rng.standard_normal((N, C)).astype(np.float32)
    roll = np.abs(rng.standard_normal((N, R))).astype(np.float32)
    kw = dict(stage=1, use_uniform=use_uniform, ot_part=ot_part)
    ref = np.stack([
        np.asarray(jax_calc_similarity_rollout(
            jnp.asarray(centers[q]), jnp.asarray(an[q]), jnp.asarray(roll[q]),
            jnp.asarray(centers), jnp.asarray(fb), jnp.asarray(roll), **kw)[0])
        for q in range(Q)
    ])
    # the port takes the queries as a leading batch axis
    t = torch.from_numpy
    out, aux = calc_similarity_rollout(
        t(centers[:Q]), t(an), t(roll[:Q]),
        t(centers)[None].expand(Q, -1, -1), t(fb)[None].expand(Q, -1, -1, -1),
        t(roll)[None].expand(Q, -1, -1), **kw,
    )
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert aux.T.shape[-1] == (R if ot_part > 0.999 else R + 1)
    g0, _ = calc_similarity_rollout(t(centers[0]), None, None, t(centers), None, None, stage=0)
    np.testing.assert_allclose(g0.numpy(), centers @ centers[0], rtol=1e-5, atol=1e-6)


def test_l2_normalize_matches_torch_normalize():
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 8, 3)).astype(np.float32))
    x[0] = 0.0
    torch.testing.assert_close(l2_normalize(x, dim=1), torch.nn.functional.normalize(x, dim=1))
