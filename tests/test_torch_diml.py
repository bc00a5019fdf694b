"""The port's DIML structural-loss training and its evaluation against the
JAX package's, on the CPU at a small size: the training-time OT
(losses/diml_ot.py), the margin_diml loss's value and gradients on fixed
triplets, the training-mode extraction, the train_diml precision rule, and
the train_diml and test_diml_base CLIs end to end.

Tolerances are stated where they are used.
"""

import shutil
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vit_reranking_tpu.miners.common as jax_mc
from vit_reranking_tpu.engine.extract import extract_features as jax_extract
from vit_reranking_tpu.losses.diml_ot import (pair_wise_wdist as jax_wdist,
                                              training_cross_attention as jax_cross)
from vit_reranking_tpu.losses.margin_diml import MarginDIMLLoss as JaxMarginDIMLLoss
from vit_reranking_tpu.models.cvt import CvTDIML as JaxCvTDIML, CvTSpec as JaxSpec

from vit_reranking_tpu_torch import losses
from vit_reranking_tpu_torch.cli import test_diml, test_diml_base, train_diml
from vit_reranking_tpu_torch.core.config import Config, resolve_diml_precision
from vit_reranking_tpu_torch.data.device_cache import DeviceEvalCache
from vit_reranking_tpu_torch.data.loader import build_eval_loaders
from vit_reranking_tpu_torch.engine.extract import embed_split
from vit_reranking_tpu_torch.losses.diml_ot import pair_wise_wdist, training_cross_attention
from vit_reranking_tpu_torch.losses.margin_diml import MarginDIMLLoss
from vit_reranking_tpu_torch.miners.common import Triplets
from vit_reranking_tpu_torch.models.cvt import CvTDIML, CvTSpec
from vit_reranking_tpu_torch.weights import load_jax_params

torch.set_num_threads(2)

B, G, D = 8, 3, 8  # batch, per-patch grid (R = 9), embedding width
LABELS = np.repeat(np.arange(4), 2).astype(np.int32)
# fixed triplets: each anchor's class partner, a negative two places on
TRIPLETS = (np.arange(B), np.arange(B) ^ 1, (np.arange(B) + 2) % B)
SMALL = dict(dim_embed=(64, 64, 64), num_heads=(1, 1, 1), depth=(1, 1, 1),
             drop_path_rate=(0.0, 0.0, 0.0))
# the synthetic recipe of the JAX package's test_device_cache.py:270-285, cut
# to one step (4 classes x 2 images a split, batch 8)
CLI_ARGS = ["--dataset", "synthetic", "--synthetic_size", "32", "--synthetic_classes", "4",
            "--synthetic_per_class", "2", "--kernels", "1", "--bs", "8", "--loss",
            "margin_diml", "--batch_mining", "distance", "--n_epochs", "1", "--evalevery", "1",
            "--lr", "0.0001", "--embed_dim", "16", "--device", "cpu"]


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    ok = ~np.isnan(want)
    scale = max(np.abs(want[ok]).max(), 1e-30) if ok.any() else 1.0
    err = np.abs(got[ok] - want[ok]).max() / scale if ok.any() else 0.0
    assert err <= rtol, (what, err)


@pytest.mark.parametrize("use_inverse", [False, True])
def test_training_cross_attention_matches_jax(use_inverse):
    """u and v within 1e-5 relative (f32 products summed in another order)."""
    rng = np.random.default_rng(0)
    x, y = (rng.standard_normal((B, D, G * G)).astype(np.float32) for _ in range(2))
    xm, ym = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(2))
    ref = jax_cross(*(jnp.asarray(a) for a in (x, y, xm, ym)), use_inverse=use_inverse)
    got = training_cross_attention(*(torch.from_numpy(a) for a in (x, y, xm, ym)),
                                   use_inverse=use_inverse)
    for g, r in zip(got, ref):
        _close(g.numpy(), r, 1e-5)


@pytest.mark.parametrize("kind", ["default", "uniform", "inverse", "means", "negative"])
def test_pair_wise_wdist_matches_jax(kind):
    """The OT-weighted distance of each pair, positive (Sinkhorn plan, one
    exit flag for the batch) and negative (T = ones), with the JAX
    package's marginals, uniform ones, the inverse attention and passed
    means: 1e-5 relative (100 Sinkhorn iterations of f32 mat-vecs in
    another sum order)."""
    rng = np.random.default_rng(1)
    x, y = (rng.standard_normal((B, D, G * G)).astype(np.float32) for _ in range(2))
    means = [rng.standard_normal((B, D)).astype(np.float32) for _ in range(2)]
    kw = dict(use_uniform=kind == "uniform", use_inverse=kind == "inverse",
              is_positive=kind != "negative")
    m = means if kind == "means" else [None, None]
    ref = jax_wdist(jnp.asarray(x), jnp.asarray(y),
                    *(None if a is None else jnp.asarray(a) for a in m), **kw)
    got = pair_wise_wdist(torch.from_numpy(x), torch.from_numpy(y),
                          *(None if a is None else torch.from_numpy(a) for a in m), **kw)
    _close(got.numpy(), ref, 1e-5)


class _JaxFixedMiner:
    name = "distance"

    def __call__(self, key, batch, labels):
        a, p, n = (jnp.asarray(t, jnp.int32) for t in TRIPLETS)
        return jax_mc.Triplets(a, p, n, jnp.ones((B,), bool))


class _FixedMiner:
    name = "distance"

    def __call__(self, batch, labels, generator=None):
        a, p, n = (torch.from_numpy(t).long() for t in TRIPLETS)
        return Triplets(a, p, n, torch.ones(B, dtype=torch.bool))


def _feats(kind):
    """(B, G, G, D) per-patch features.  "nan_plan": images 0 and 1 (each
    other's positive) point every patch against the other's mean, so both
    of their cross-attention marginals have zero mass and their plans go
    NaN."""
    rng = np.random.default_rng(2)
    f = rng.standard_normal((B, G, G, D)).astype(np.float32)
    if kind == "nan_plan":
        base = rng.standard_normal(D).astype(np.float32)
        f[0] = base + 0.05 * rng.standard_normal((G, G, D))
        f[1] = -base + 0.05 * rng.standard_normal((G, G, D))
    return f


CASES = {
    "default": {},
    "uniform": dict(use_uniform=True),
    "inverse": dict(use_inverse=True),
    "cls_token": dict(use_cls_token=True),
    "nan_plan": {},
    "no_active_pair": dict(loss_margin_margin=-5.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_margin_diml_value_and_grads_match_jax(case):
    """Value and gradients in the features, in beta and (``use_cls_token``)
    in the class token, fixed triplets: 1e-5 relative.  "nan_plan": two
    pairs' plans are NaN; both packages drop those triplets from the value
    and give NaN gradients at the same entries (0 times the NaN plan).
    "no_active_pair": the unnormalised total, 0, and zero gradients."""
    opt = types.SimpleNamespace(n_classes=4, loss_margin_beta=1.05, **CASES[case])
    f = _feats(case)
    cls_tok = np.random.default_rng(3).standard_normal((B, D)).astype(np.float32)
    jl = JaxMarginDIMLLoss(opt, _JaxFixedMiner())
    params = jl.init_params(jax.random.PRNGKey(0))
    val, grads = jax.value_and_grad(
        lambda b, p, c: jl(p, b, jnp.asarray(LABELS), key=None, class_token=c),
        argnums=(0, 1, 2))(jnp.asarray(f), params, jnp.asarray(cls_tok))
    tl = MarginDIMLLoss(opt, _FixedMiner())
    tf = torch.from_numpy(f).requires_grad_()
    tc = torch.from_numpy(cls_tok).requires_grad_()
    out = tl(tf, torch.from_numpy(LABELS).long(), class_token=tc)
    out.backward()
    assert np.isfinite(float(val))
    _close(out.detach().numpy(), np.asarray(val), 1e-5, "loss")
    _close(tf.grad.numpy(), grads[0], 1e-5, "features")
    _close(tl.beta.grad.numpy(), grads[1]["beta"], 1e-5, "beta")
    if case == "cls_token":
        _close(tc.grad.numpy(), grads[2], 1e-5, "class_token")
    else:
        assert tc.grad is None
    if case == "nan_plan":
        rows = np.isnan(tf.grad.numpy()).reshape(B, -1).any(1)
        assert np.flatnonzero(rows).tolist() == [0, 1, 2, 7]
    if case == "no_active_pair":
        assert float(val) == float(out.detach()) == 0.0 and not tf.grad.numpy().any()


def test_use_cls_token_needs_the_class_token():
    opt = types.SimpleNamespace(n_classes=4, use_cls_token=True)
    with pytest.raises(KeyError, match="class_token"):
        MarginDIMLLoss(opt, _FixedMiner())(torch.zeros(B, G, G, D),
                                           torch.from_numpy(LABELS).long())
    assert isinstance(losses.select("margin_diml", Config(n_classes=4),
                                    types.SimpleNamespace(name="distance")), MarginDIMLLoss)


def test_training_mode_extraction_matches_jax(tmp_path):
    """A CvT-DIML (narrow spec, grid 2) on a 32 px synthetic test split:
    ``embed_split(training_mode=True)`` from the loader and from the
    resident pool against the JAX package's ``extract_features(
    training_mode=True)`` on the same weights: the per-patch bank (B, D,
    4) and the cls-head center, 1e-5 after the L2 norms."""
    opt = Config(dataset="synthetic", synthetic_size=32, synthetic_classes=2,
                 synthetic_per_class=4, bs=4, kernels=1, device="cpu")
    loader = build_eval_loaders(opt)["testing"]
    jm = JaxCvTDIML(embed_dim=D, grid_size=2, spec=JaxSpec(**SMALL))
    variables = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 32, 32, 3)), train=False))(
        jax.random.PRNGKey(0))
    ref = jax_extract(jm, variables, loader, grid_size=2, training_mode=True)
    tm = load_jax_params(CvTDIML(embed_dim=D, grid_size=2, spec=CvTSpec(**SMALL)),
                         jax.tree.map(np.asarray, variables))
    pool = DeviceEvalCache.from_dataset(loader.dataset, torch.device("cpu"), workers=1)
    for source in (None, pool):
        got = embed_split(tm, loader, source, grid_size=2, device="cpu", training_mode=True)
        assert got["bank"].shape == (len(ref["labels"]), D, 4)
        for k in ("bank", "center"):
            _close(got[k].numpy(), ref[k], 1e-5, k)
        np.testing.assert_array_equal(got["labels"].numpy(), ref["labels"])


@pytest.mark.parametrize("arch", ["cvt_13_diml", "cvt_13_diml_frozen", "resnet50_diml_frozen",
                                  "resnet50_frozen_normalize", "irresnet50", "swin_normalize"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_train_diml_precision_rule(arch, device):
    """The JAX train_diml rule (train_diml.py:74-85, "the device is CUDA"
    for "the backend is a TPU"): bf16 for every cvt arch, DIML included,
    and resnet50 / irresnet50 on the card; f32 on the CPU and for other
    arches; narrow_sm follows bf16."""
    opt = resolve_diml_precision(Config(arch=arch, device=device))
    want = device == "cuda" and arch.startswith(("cvt", "resnet50", "irresnet50"))
    assert (opt.bf16, opt.narrow_sm) == (want, want)


@pytest.mark.parametrize("flags,want", [
    (dict(bf16=False), (False, False)),
    (dict(narrow_sm=False), (True, False)),
    (dict(bf16=True, device="cpu"), (True, True)),
])
def test_train_diml_precision_explicit_flags_win(flags, want):
    opt = resolve_diml_precision(Config(**{"arch": "cvt_diml", "device": "cuda", **flags}))
    assert (opt.bf16, opt.narrow_sm) == want


@pytest.mark.parametrize("arch,extra", [
    ("resnet50_diml", []), ("resnet50_diml", ["--cache_device"]),
    ("cvt_13", ["--grid_size", "2", "--use_cls_token"]),
    ("cvt_13", ["--grid_size", "2", "--use_cls_token", "--cache_device"]),
])
def test_train_diml_main_on_cpu(monkeypatch, tmp_path, arch, extra):
    """train_diml end to end on the CPU, as the JAX package's
    test_device_cache.py:270-285 runs it: full ResNet-50-DIML, and CvT-13
    (rewritten to its DIML form, the cls embedding passed to the loss),
    on a 32 px synthetic set of 4 classes x 2 images a split at batch 8:
    one step and the evaluation, from the loader and from the device
    pools; checkpoints under --save_path."""
    monkeypatch.chdir(tmp_path)
    runs = tmp_path / "runs"
    try:
        out = train_diml.main(CLI_ARGS + ["--arch", arch, "--save_path", str(runs)] + extra)
        state = out["state"]
        assert (state.model.__class__.__name__ == "CvTDIML") == arch.startswith("cvt")
        assert state.pass_class_token == ("--use_cls_token" in extra)
        assert len(out["step_loss"]) == 1 and all(np.isfinite(out["step_loss"]))
        ev = out["eval"][-1]
        assert set(ev) == {"r1", "rp", "mapr", "r1_global"}
        assert all(0.0 <= v <= 100.0 for v in ev.values())
        assert (runs / "synthetic" / "default_s1" / "best" / "state.pt").exists()
    finally:
        # a run's `latest` and `best` hold the model and Adam's state, 0.3 GB
        # each for ResNet-50: free them before the next test
        shutil.rmtree(runs, ignore_errors=True)


def test_test_diml_base_on_cpu(monkeypatch, tmp_path):
    """test_diml_base with scripts/diml/test_diml.sh's flags (ResNet-50,
    grid 4, uniform marginals) at 64 px, so the 2 x 2 map is resized to
    the 4 x 4 rerank grid; the featvit rerank of each query's top 5 on the
    (N, 2048, 16) bank."""
    monkeypatch.chdir(tmp_path)
    assert test_diml_base.main is test_diml.main
    calls = []
    real = test_diml.rerank_evaluate

    def spy(bank, *a, **kw):
        calls.append((tuple(bank.shape), kw["method"]))
        return real(bank, *a, **kw)

    monkeypatch.setattr(test_diml, "rerank_evaluate", spy)
    res = test_diml.run_eval(Config(
        dataset="synthetic", synthetic_size=64, synthetic_classes=2, synthetic_per_class=4,
        arch="resnet50_frozen_normalize", embed_dim=128, grid_size=4, use_uniform=True, bs=16,
        device="cpu", kernels=1), trunc_nums=(0, 5))
    assert calls == [((8, 2048, 16), "featvit")]
    assert set(res["r1"]) == {0, 5} and all(0.0 <= v <= 100.0 for v in res["mapr"].values())
    assert (tmp_path / "test_results" / "test_diml_synthetic.csv").exists()
