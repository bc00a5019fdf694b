"""The port's featvit rerank method (cross-attention marginals, kernel K1's
modes a/b/c) against the JAX package's, on the same numpy inputs.

``cross_attention_marginals`` and ``calc_similarity`` (the eager path) for
every marginal variant and both OT kinds, and ``fused_featvit_rerank_scores``
(JAX's Pallas kernel in interpret mode, the port's plain version of K1),
within 1e-5 absolute with identical rankings: the two sides sum the same
f32 terms in other orders, and the exit decisions come out the same.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vit_reranking_tpu.ops.rerank_pallas import (
    fused_featvit_rerank_scores as jax_fused_featvit_rerank_scores,
)
from vit_reranking_tpu.ops.similarity import (
    calc_similarity as jax_calc_similarity,
    cross_attention_marginals as jax_cross_attention_marginals,
)
from vit_reranking_tpu_torch.ops.rerank import fused_featvit_rerank_scores
from vit_reranking_tpu_torch.ops.similarity import calc_similarity, cross_attention_marginals

torch.set_num_threads(2)

TOL = 1e-5
VARIANTS = {
    "relu": {}, "uniform": dict(use_uniform=True),
    "inverse": dict(use_inverse=True, temperature=0.1),
    "minus": dict(use_minus=True), "minus-over-inverse": dict(use_minus=True, use_inverse=True),
    "soft": dict(use_soft=True), "cls-token": dict(use_cls_token=True),
    "minus-cls-token": dict(use_minus=True, use_cls_token=True, temperature=0.1),
}


def _problem(seed, N=16, K=8, C=24, R=49):
    rng = np.random.default_rng(seed)
    fb = rng.standard_normal((N, C, R)).astype(np.float32)
    fb /= np.linalg.norm(fb, axis=1, keepdims=True)
    centers = fb.mean(-1) + 0.1 * rng.standard_normal((N, C)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    sims = centers @ centers.T
    np.fill_diagonal(sims, -100)
    top = np.argsort(-sims, 1, kind="stable")[:, :K].astype(np.int32)
    return fb, centers, top


def _same_order(a, b):
    return np.array_equal(np.argsort(-a, 1, kind="stable"), np.argsort(-b, 1, kind="stable"))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", [n for n in VARIANTS if "cls" not in n])
def test_cross_attention_marginals_match_jax(name):
    fb, centers, top = _problem(0)
    flags = VARIANTS[name]
    for i in range(3):
        ref = jax_cross_attention_marginals(fb[i], centers[i], fb[top[i]], centers[top[i]], **flags)
        out = cross_attention_marginals(_t(fb[i]), _t(centers[i]), _t(fb[top[i]]),
                                        _t(centers[top[i]]), **flags)
        for a, b in zip(out, ref):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    # a tile of queries at once (the leading axis) gives the same marginals
    tile = cross_attention_marginals(_t(fb[:3]), _t(centers[:3]), _t(fb[top[:3]]),
                                     _t(centers[top[:3]]), **flags)
    one = cross_attention_marginals(_t(fb[2]), _t(centers[2]), _t(fb[top[2]]),
                                    _t(centers[top[2]]), **flags)
    np.testing.assert_allclose(tile[0][2].numpy(), one[0].numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tile[1][2].numpy(), one[1].numpy(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("ot_part", [1.0, 0.5], ids=["full", "partial-0.5"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_calc_similarity_matches_jax(name, ot_part):
    fb, centers, top = _problem(1)
    flags = dict(VARIANTS[name], ot_part=ot_part)
    ref = np.stack([np.asarray(jax_calc_similarity(
        fb[i], centers[i], fb[top[i]], centers[top[i]], stage=1, **flags)[0])
        for i in range(len(fb))])
    tile, aux = calc_similarity(_t(fb), _t(centers), _t(fb[top]), _t(centers[top]), stage=1,
                                **flags)
    R = 49 + (ot_part <= 0.999)
    assert aux.T.shape == (16, 8, R, R)
    np.testing.assert_allclose(tile.numpy(), ref, rtol=0, atol=TOL)
    assert _same_order(tile.numpy(), ref)


@pytest.mark.parametrize("ot_part", [1.0, 0.5], ids=["full", "partial-0.5"])
@pytest.mark.parametrize("name", ["relu", "inverse", "minus", "soft", "uniform",
                                  "minus-cls-token"])
def test_fused_featvit_matches_jax(name, ot_part):
    fb, centers, top = _problem(2)
    flags = dict(VARIANTS[name], ot_part=ot_part)
    ref = np.asarray(jax_fused_featvit_rerank_scores(
        *map(jnp.asarray, (fb, centers, top)), query_tile=8, interpret=True, **flags))
    out = fused_featvit_rerank_scores(_t(fb), _t(centers), _t(top.astype(np.int64)),
                                      query_tile=8, **flags).numpy()
    assert out.shape == ref.shape == (16, 8)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    assert _same_order(out, ref)


def test_test_diml_cvt_takes_featvit_without_rollout(monkeypatch, tmp_path):
    """Without --use_rollout or --use_qk the CLI reranks CvT features by the
    featvit method (JAX cli/test_diml.py:148-154) through the fused path:
    full CvT-13 on 6 images of 64 px, rerank grid 4, top-4."""
    from vit_reranking_tpu_torch.cli.test_diml import run_eval
    from vit_reranking_tpu_torch.core.config import from_args
    from vit_reranking_tpu_torch.ops import rerank

    shapes = []
    plain = rerank.sinkhorn_scores_plain
    monkeypatch.setattr(rerank, "sinkhorn_scores_plain",
                        lambda S, *a, **kw: shapes.append(tuple(S.shape)) or plain(S, *a, **kw))
    monkeypatch.chdir(tmp_path)
    res = run_eval(from_args([
        "--dataset", "synthetic", "--arch", "cvt_13_normalize", "--embed_dim", "16",
        "--use_ot", "--grid_size", "4", "--device", "cpu", "--synthetic_classes", "2",
        "--synthetic_per_class", "3", "--synthetic_size", "64", "--bs", "3", "--kernels", "2",
    ]), trunc_nums=(0, 4))
    assert shapes == [(6 * 4, 16, 16)]
    assert all(0.0 <= x <= 100.0 for m in res for x in res[m].values())
    rows = (tmp_path / "test_results" / "test_diml_synthetic.csv").read_text().splitlines()
    assert rows[1].split(",")[3] == "featvit"
