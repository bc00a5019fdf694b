"""The port's DeiT evaluation end to end against the JAX package's: the qk
and featvit rerank methods, fused and eager, from synthetic images through
features and the rerank to R@1 / RP / MAP@R, then the port's
``test_diml_vit`` CLI on the CPU.

The ViT is cut for the CPU (embed 16, dim 48, depth 2, 3 heads, patch 8) and
the images are 32 px, so the token grid is 4 x 4 and the rerank grid 4 (the
qk method needs one rerank patch a token).  Each side extracts and reranks
its own features: features agree within 1e-5; R@1 and RP are equal and
MAP@R within 1e-4 points (f32 sums in another order,
tests/test_torch_topk_metrics.py), and the fused scores rank the candidates
identically.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import vit_reranking_tpu.models.vit as jax_vit
from vit_reranking_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from vit_reranking_tpu.data.loader import DataLoader as JaxLoader
from vit_reranking_tpu.engine.extract import extract_features as jax_extract_features
from vit_reranking_tpu.engine.rerank_eval import rerank_evaluate as jax_rerank_evaluate
from vit_reranking_tpu.ops.rerank_pallas import (
    fused_featvit_rerank_scores as jax_fused_featvit,
    fused_qk_rerank_scores as jax_fused_qk,
)
from vit_reranking_tpu_torch.data.datasets import SyntheticDataset
from vit_reranking_tpu_torch.data.loader import DataLoader
from vit_reranking_tpu_torch.engine.extract import extract_features
from vit_reranking_tpu_torch.engine.rerank_eval import rerank_evaluate
from vit_reranking_tpu_torch.models.vit import ViTNetwork
from vit_reranking_tpu_torch.ops.rerank import fused_featvit_rerank_scores, fused_qk_rerank_scores
from vit_reranking_tpu_torch.weights import load_jax_params

from test_torch_vit import jax_vit_variables

torch.set_num_threads(2)

SMALL = dict(embed_dim=16, dim=48, depth=2, num_heads=3, patch=8)
SIZE, GRID, TRUNC = 32, 4, 16
TOL = 1e-5


@pytest.fixture(scope="module")
def features():
    jm = jax_vit.ViTNetwork(**SMALL)
    variables = jax_vit_variables(jm, SIZE, 3)
    tm = load_jax_params(ViTNetwork(**SMALL, img_size=SIZE), variables)
    kw = dict(n_classes=4, per_class=8, size=SIZE, seed=4)
    jf = jax_extract_features(
        jm, variables, JaxLoader(JaxSynthetic(**kw), batch_size=8, num_workers=2),
        grid_size=GRID, use_qk=True, pad_batch=8,
    )
    tf = extract_features(
        tm, DataLoader(SyntheticDataset(**kw), batch_size=8, num_workers=2),
        grid_size=GRID, use_qk=True, device="cpu",
    )
    return jf, {k: v.numpy() for k, v in tf.items()}


def test_extract_features_match_jax(features):
    jf, tf = features
    assert np.array_equal(tf["labels"], jf["labels"])
    assert tf["bank"].shape == (32, 16, GRID**2) and tf["q"].shape == (32, 3, 17, 16)
    for k in ("bank", "center", "q", "k"):
        assert tf[k].shape == jf[k].shape
        np.testing.assert_allclose(tf[k], jf[k], rtol=TOL, atol=TOL, err_msg=k)


def _evaluate(fn, feats, method, flags, use_fused, array):
    aux = dict(rollout=array(feats["q"]), rollout_g=array(feats["k"])) if method == "qk" else {}
    return fn(array(feats["bank"]), array(feats["center"]), array(feats["labels"]),
              trunc_nums=(0, TRUNC), method=method, flags=flags, use_fused=use_fused, **aux)


@pytest.mark.parametrize("method,flags", [
    ("qk", dict(use_ot=True, qk_scale=1.0 / 8.0)),
    ("qk", dict(use_ot=True, qk_scale=1.0 / 8.0, use_inverse=True, temperature=0.1)),
    ("qk", dict(use_ot=False, qk_scale=1.0 / 8.0)),
    ("featvit", dict(use_ot=True)),
    ("featvit", dict(use_ot=True, ot_part=0.5)),
    ("featvit", dict(use_ot=True, use_minus=True, use_cls_token=True, temperature=0.1)),
], ids=["qk", "qk-exp", "qk-dual-softmax", "featvit", "featvit-partial", "featvit-minus-cls"])
@pytest.mark.parametrize("use_fused", [None, False], ids=["default", "eager"])
def test_slice_metrics_match_jax(features, method, flags, use_fused):
    jf, tf = features
    ref = _evaluate(jax_rerank_evaluate, jf, method, flags, use_fused, jnp.asarray)
    out = _evaluate(rerank_evaluate, tf, method, flags, use_fused, torch.from_numpy)
    for m in ("r1", "rp", "mapr"):
        for t in (0, TRUNC):
            assert abs(out[m][t] - ref[m][t]) < (1e-4 if m == "mapr" else 1e-9), (m, t)


def test_fused_scores_rank_like_jax(features):
    """The fused scores of both methods on each side's own features: within
    1e-5 and the same order of every query's candidates."""
    jf, tf = features
    centers = tf["center"]
    sims = centers @ centers.T
    np.fill_diagonal(sims, -100)
    top = np.argsort(-sims, 1, kind="stable")[:, :TRUNC]
    pairs = [
        (jax_fused_qk(*map(jnp.asarray, (jf["bank"], jf["q"], jf["k"], top.astype(np.int32))),
                      query_tile=16, interpret=True),
         fused_qk_rerank_scores(*map(torch.from_numpy, (tf["bank"], tf["q"], tf["k"], top)),
                                query_tile=16)),
        (jax_fused_featvit(*map(jnp.asarray, (jf["bank"], jf["center"], top.astype(np.int32))),
                           query_tile=16, interpret=True),
         fused_featvit_rerank_scores(*map(torch.from_numpy, (tf["bank"], tf["center"], top)),
                                     query_tile=16)),
    ]
    for ref, out in pairs:
        ref, out = np.asarray(ref), out.numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
        assert np.array_equal(np.argsort(-out, 1, kind="stable"), np.argsort(-ref, 1, kind="stable"))


def test_unported_methods_raise(features):
    _, tf = features
    for method in ("cam", "mhvit", "dist"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _evaluate(rerank_evaluate, tf, method, {}, None, torch.from_numpy)


@pytest.mark.parametrize("extra,method", [(["--use_qk", "--blk_ind", "1"], "qk"), ([], "featvit")])
def test_test_diml_vit_on_cpu(monkeypatch, tmp_path, extra, method):
    """The port's entry point at full DeiT-S width on a small synthetic set
    (104 images of 32 px, so a 2 x 2 token grid and --grid_size 2; exact
    top-100); the CSV row names the method."""
    from vit_reranking_tpu_torch.cli import test_diml_vit

    monkeypatch.chdir(tmp_path)
    res = test_diml_vit.main([
        "--dataset", "synthetic", "--arch", "vit_normalize", "--embed_dim", "16",
        "--use_ot", "--grid_size", "2", "--device", "cpu", "--synthetic_classes", "4",
        "--synthetic_per_class", "26", "--synthetic_size", "32", "--bs", "16", "--kernels", "2",
    ] + extra)
    for m in res:
        assert set(res[m]) == {0, 100}
        assert all(0.0 <= x <= 100.0 for x in res[m].values())
    rows = (tmp_path / "test_results" / "test_diml_synthetic.csv").read_text().splitlines()
    assert len(rows) == 2 and rows[1].split(",")[3] == method
