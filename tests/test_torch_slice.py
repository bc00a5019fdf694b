"""The port's rollout-rerank evaluation end to end against the JAX package's:
CvT forward on carried weights, then synthetic images -> features -> rerank
-> metrics, then the port's CLI entry point on the CPU.

Model size is cut for the CPU (``dim_embed (16, 32, 64)``, ``depth
(1, 1, 2)``) and the input is 112 px, so stage 0's attention map (784 x 196
entries) takes the bisection branch of the rollout filter; stage 2 is then
7x7 tokens with 4x4 keys, so the rollout grid is 4.  Forward outputs agree to
1e-5 (f32 convolutions, LayerNorms and products sum in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vit_reranking_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from vit_reranking_tpu.data.loader import DataLoader as JaxLoader
from vit_reranking_tpu.engine.extract import extract_features as jax_extract_features
from vit_reranking_tpu.engine.rerank_eval import rerank_evaluate as jax_rerank_evaluate
from vit_reranking_tpu.models.cvt import CvTNetwork as JaxCvT, CvTSpec as JaxSpec
from vit_reranking_tpu_torch.cli.test_diml import run_eval
from vit_reranking_tpu_torch.core.config import from_args
from vit_reranking_tpu_torch.data.datasets import SyntheticDataset
from vit_reranking_tpu_torch.data.loader import DataLoader
from vit_reranking_tpu_torch.engine.extract import extract_features
from vit_reranking_tpu_torch.engine.rerank_eval import rerank_evaluate
from vit_reranking_tpu_torch.models.cvt import CvTNetwork, CvTSpec
from vit_reranking_tpu_torch.weights import load_jax_params

torch.set_num_threads(2)

SMALL = dict(dim_embed=(16, 32, 64), depth=(1, 1, 2), num_heads=(1, 2, 2))
GRID = 4
TOL = 1e-5


def _perturbed(tree, rng, positive=False):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng, positive)
        else:
            v = np.asarray(v) + 0.1 * rng.standard_normal(np.shape(v)).astype(np.float32)
            out[k] = np.abs(v) if positive else v
    return out


@pytest.fixture(scope="module")
def models():
    jm = JaxCvT(embed_dim=16, spec=JaxSpec(**SMALL), rollout_grid=GRID)
    x0 = jnp.zeros((2, 112, 112, 3), jnp.float32)
    v = jax.jit(lambda key: jm.init({"params": key}, x0, train=False))(jax.random.PRNGKey(0))
    # move every parameter and BN statistic off its init value, so each one
    # of them is exercised by the comparison
    rng = np.random.default_rng(0)
    variables = {
        "params": _perturbed(v["params"], rng),
        "batch_stats": _perturbed(v["batch_stats"], rng, positive=True),
    }
    tm = CvTNetwork(embed_dim=16, spec=CvTSpec(**SMALL), rollout_grid=GRID)
    load_jax_params(tm, variables).eval()
    return jm, variables, tm


def test_cvt_forward_matches_jax(models):
    jm, variables, tm = models
    x = np.random.default_rng(1).standard_normal((3, 112, 112, 3)).astype(np.float32)
    apply = jax.jit(lambda v, x: jm.apply(v, x, train=False, ret_attn=True))
    je, (jenc, jtok), jaux = apply(variables, jnp.asarray(x))
    with torch.no_grad():
        te, (tenc, ttok), taux = tm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                                    ret_attn=True)
    pairs = [
        (je, te), (jenc, tenc), (jtok, ttok),
        (jaux["head_tokens"], taux["head_tokens"]),
        (jaux["rollout_maps"], taux["rollout_maps"]),
    ]
    for ref, out in pairs:
        assert tuple(out.shape) == tuple(ref.shape)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    assert taux["rollout_maps"].shape == (4, 3, GRID**2, GRID**2)


def test_load_jax_params_is_strict(models):
    _, variables, _ = models
    fresh = lambda: CvTNetwork(embed_dim=16, spec=CvTSpec(**SMALL), rollout_grid=GRID)
    missing = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}
    del missing["params"]["head"]
    with pytest.raises(KeyError):
        load_jax_params(fresh(), missing)
    extra = {"params": dict(variables["params"], bogus={"kernel": np.zeros((2, 2))}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError):
        load_jax_params(fresh(), extra)
    wrong = {"params": dict(variables["params"], head={"kernel": np.zeros((64, 8)),
                                                        "bias": np.zeros(8)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError):
        load_jax_params(fresh(), wrong)


def test_synthetic_images_equal_jax():
    kw = dict(n_classes=3, per_class=2, size=32, seed=5, sep=0.7, nuisance=0.5)
    ours, ref = SyntheticDataset(**kw), JaxSynthetic(**kw)
    assert len(ours) == len(ref) and ours.avail_classes == ref.avail_classes
    for i in range(len(ref)):
        lab, img, idx = ours[i]
        rlab, rimg, ridx = ref[i]
        assert (lab, idx) == (rlab, ridx) and np.array_equal(img, rimg)


@pytest.fixture(scope="module")
def features(models):
    jm, variables, tm = models
    kw = dict(n_classes=4, per_class=8, size=112, seed=2)
    jf = jax_extract_features(
        jm, variables, JaxLoader(JaxSynthetic(**kw), batch_size=8, num_workers=2),
        grid_size=GRID, use_rollout=True, pad_batch=8,
    )
    tf = extract_features(
        tm, DataLoader(SyntheticDataset(**kw), batch_size=8, num_workers=2),
        grid_size=GRID, use_rollout=True, device="cpu",
    )
    tf = {k: v.numpy() for k, v in tf.items()}
    return jf, tf


def test_extract_features_match_jax(features):
    jf, tf = features
    assert np.array_equal(tf["labels"], jf["labels"])
    for k in ("bank", "center", "rollout"):
        assert tf[k].shape == jf[k].shape
        np.testing.assert_allclose(tf[k], jf[k], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("ot_part", [1.0, 0.5], ids=["full", "partial-0.5"])
def test_slice_metrics_match_jax(features, ot_part):
    """Each side reranks its own features: the metrics agree to the f32
    summation order of MAP@R (see tests/test_torch_topk_metrics.py), R@1 and
    RP exactly."""
    jf, tf = features
    flags = dict(ot_part=ot_part)
    ref = jax_rerank_evaluate(
        jnp.asarray(jf["bank"]), jnp.asarray(jf["center"]), jnp.asarray(jf["labels"]),
        rollout=jnp.asarray(jf["rollout"]), trunc_nums=(0, 16), method="rollout",
        flags=flags,
    )
    out = rerank_evaluate(
        torch.from_numpy(tf["bank"]), torch.from_numpy(tf["center"]),
        torch.from_numpy(tf["labels"]), rollout=torch.from_numpy(tf["rollout"]),
        trunc_nums=(0, 16), method="rollout", flags=flags,
    )
    for m in ("r1", "rp", "mapr"):
        for t in (0, 16):
            assert abs(out[m][t] - ref[m][t]) < (1e-4 if m == "mapr" else 1e-9), (m, t)


def test_eager_path_matches_fused_for_full_ot(features):
    """use_fused=False (per-query batch-mean exit) ranks like the fused
    per-pair exit for full OT, as the JAX package verified."""
    _, tf = features
    args = (torch.from_numpy(tf["bank"]), torch.from_numpy(tf["center"]),
            torch.from_numpy(tf["labels"]))
    kw = dict(rollout=torch.from_numpy(tf["rollout"]), trunc_nums=(0, 16))
    fused = rerank_evaluate(*args, **kw)
    eager = rerank_evaluate(*args, use_fused=False, **kw)
    for m in fused:
        assert abs(fused[m][16] - eager[m][16]) < 1e-4, m


def test_run_eval_on_cpu(monkeypatch, tmp_path):
    """The port's CLI path at full CvT-13 width on a tiny synthetic set; the
    CSV goes to test_results/ under the working directory."""
    monkeypatch.chdir(tmp_path)
    opt = from_args([
        "--dataset", "synthetic", "--arch", "cvt_13_normalize", "--embed_dim", "16",
        "--use_rollout", "--use_ot", "--device", "cpu", "--synthetic_classes", "2",
        "--synthetic_per_class", "3", "--bs", "3", "--kernels", "2",
    ])
    res = run_eval(opt, trunc_nums=(0, 4))
    assert set(res) == {"r1", "rp", "mapr"}
    for m in res:
        assert set(res[m]) == {0, 4}
        assert all(0.0 <= x <= 100.0 for x in res[m].values())
    rows = (tmp_path / "test_results" / "test_diml_synthetic.csv").read_text().splitlines()
    assert len(rows) == 2 and rows[0].startswith("arch,grid,ot_part,method")
