"""The port's blocked exact top-k and retrieval metrics against the JAX
package's, on the same numpy inputs.

Top-k indices are equal, ties included.  R@1 and RP are equal bit for bit
(sums of 0/1 and one division); MAP@R sums ~N f32 precision terms, and XLA
and PyTorch add them in different orders, so it agrees to a few ulp
(rtol 1e-6) and the dataset-level percentages to 1e-4 points.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vit_reranking_tpu.engine.metrics import (
    metrics_from_ranks as jax_metrics_from_ranks,
    summarize as jax_summarize,
)
from vit_reranking_tpu.ops.topk import (
    pairwise_topk as jax_pairwise_topk,
    similarity_matrix as jax_similarity_matrix,
)
from vit_reranking_tpu_torch.engine.metrics import metrics_from_ranks, summarize
from vit_reranking_tpu_torch.ops.topk import pairwise_topk, similarity_matrix

torch.set_num_threads(2)


@pytest.mark.parametrize("k", [1, 17])
@pytest.mark.parametrize("mask_self", [False, True])
@pytest.mark.parametrize("block_size", [64, 8192], ids=["blocked", "one-block"])
def test_pairwise_topk_matches_jax(k, mask_self, block_size):
    rng = np.random.default_rng(0)
    N, C = 257, 8
    g = rng.standard_normal((N, C)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    ref_v, ref_i = jax_pairwise_topk(
        jnp.asarray(g), jnp.asarray(g), k=k, block_size=block_size, mask_self=mask_self,
    )
    vals, inds = pairwise_topk(
        torch.from_numpy(g), torch.from_numpy(g), k=k, block_size=block_size,
        mask_self=mask_self,
    )
    assert np.array_equal(inds.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref_v), rtol=1e-6, atol=1e-6)
    if mask_self:
        assert not (inds.numpy() == np.arange(N)[:, None]).any()


def test_pairwise_topk_ties_go_to_lower_index():
    """Duplicated gallery rows tie exactly; both sides keep the lower index
    first, across block boundaries too."""
    rng = np.random.default_rng(1)
    g = rng.standard_normal((10, 4)).astype(np.float32)
    g = np.concatenate([g, g, g], 0)
    q = g[:5]
    ref_v, ref_i = jax_pairwise_topk(jnp.asarray(q), jnp.asarray(g), k=9, block_size=8)
    vals, inds = pairwise_topk(torch.from_numpy(q), torch.from_numpy(g), k=9, block_size=8)
    assert np.array_equal(inds.numpy(), np.asarray(ref_i))


def test_similarity_matrix_matches_jax():
    x = np.random.default_rng(2).standard_normal((6, 3)).astype(np.float32)
    ref = np.asarray(jax_similarity_matrix(jnp.asarray(x), jnp.asarray(x), mask_self=True))
    out = similarity_matrix(torch.from_numpy(x), torch.from_numpy(x), mask_self=True).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    assert np.all(np.diag(out) == -100.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_from_ranks_equal_jax(seed):
    rng = np.random.default_rng(seed)
    Q, N = 37, 40
    labels = rng.integers(0, 5, N)
    tops = np.stack([rng.permutation(N) for _ in range(Q)])
    ref = jax_metrics_from_ranks(jnp.asarray(tops), jnp.asarray(labels[:Q]), jnp.asarray(labels))
    out = metrics_from_ranks(
        torch.from_numpy(tops), torch.from_numpy(labels[:Q]), torch.from_numpy(labels)
    )
    for m in ("r1", "rp"):
        assert np.array_equal(out[m].numpy(), np.asarray(ref[m])), m
    np.testing.assert_allclose(out["mapr"].numpy(), np.asarray(ref["mapr"]), rtol=1e-6)
    got, want = summarize(out), jax_summarize(ref)
    assert got.keys() == want.keys()
    for m in want:
        assert abs(got[m] - want[m]) < 1e-4, m
