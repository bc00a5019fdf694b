"""The port's DeiT/ViT in bf16 (models/vit.py, the card's default training
precision for ``vit*``/``deit*``) against the JAX package's, on the CPU.

A small ViT (embed 16, dim 48, depth 2, 3 heads of 16, patch 8, 32 px, so
16 patch tokens) on weights drawn in the Flax layout and carried across:

  * the bf16 forward, with and without the narrowed softmax: embedding
    cosine > 0.995 to JAX's bf16 one and f32 outputs (the bars of
    tests/test_torch_bf16.py::test_bf16_forward_matches_jax), each block's
    output in bf16 and the LayerNorms' in f32; the port's bf16 embedding
    within twice JAX's own bf16 error (its distance to JAX's f32 one) of
    JAX's bf16 one and of JAX's f32 one.  Not closer than JAX's own error,
    as the CvT's is: a Flax Dense or Conv rounds its product to bf16 before
    it adds the bias and rounds again, PyTorch's fused bias rounds once
    (26% of the outputs a bf16 ulp apart), and JAX's erf GELU rounds after
    each of its ops; so the two packages' bf16 errors are independent, and
    over weight seeds 0-10 the port's gap to JAX's bf16 embedding was 0.86
    to 1.59 times JAX's own error (seed 10: 1.15 and 1.09; CPU);
  * three bf16 Adam steps against JAX's, at the bars of
    test_cvt_three_bf16_steps_match_jax (loss rtol 1e-2, gradient norm and
    largest gradient rtol 5e-2, lr 1e-5), on weights whose f32 steps keep
    every triplet's margin term at least 0.02 from its hinge (checked; of
    weight seeds 5-13 these, seed 10, stay furthest from it, 0.118);
  * ``select`` gives the ViT/DeiT arches the precision (it raised for bf16
    before), and train_baseline trains DeiT on the card's default
    precision (bf16, narrowed softmax) when asked for it on the CPU;
  * a bf16 qk evaluation (``--bf16``: the narrowing off, as the evaluation
    resolves no default): bank, centres, q and k within 2e-2 of the largest
    magnitude of JAX's bf16 evaluation, and the port's rerank of JAX's
    features ranks every query's candidates as JAX's rerank does.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vit_reranking_tpu.engine.rerank_eval as jax_rerank_eval
import vit_reranking_tpu.engine.train as jax_train
import vit_reranking_tpu.models.vit as jax_vit
from vit_reranking_tpu.cli.common import build_labels as jax_build_labels
from vit_reranking_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from vit_reranking_tpu.data.loader import DataLoader as JaxLoader
from vit_reranking_tpu.engine.extract import extract_features as jax_extract_features
from vit_reranking_tpu.losses.margin import MarginLoss as JaxMarginLoss

import vit_reranking_tpu_torch.engine.rerank_eval as rerank_eval
from vit_reranking_tpu_torch import models
from vit_reranking_tpu_torch.cli import train_baseline
from vit_reranking_tpu_torch.cli.common import build_labels
from vit_reranking_tpu_torch.core.config import Config, resolve_precision
from vit_reranking_tpu_torch.data.datasets import SyntheticDataset
from vit_reranking_tpu_torch.data.loader import DataLoader
from vit_reranking_tpu_torch.engine.extract import extract_features
from vit_reranking_tpu_torch.engine.train import init_train_state, make_optimizer, train_step
from vit_reranking_tpu_torch.losses.margin import MarginLoss
from vit_reranking_tpu_torch.models.vit import ViTNetwork
from vit_reranking_tpu_torch.weights import load_jax_params

from test_torch_bf16 import (B, COSINE, LABELS, LR, TRIPLETS, _check_steps, _cosine, _f32,
                             _FixedMiner, _host, _JaxFixedMiner, _margin_opt)
from test_torch_vit import jax_vit_variables

torch.set_num_threads(2)

SMALL = dict(embed_dim=16, dim=48, depth=2, num_heads=3, patch=8)
SIZE, GRID, TRUNC = 32, 4, 16
EVAL_TOL = 2e-2  # bf16 features, of the largest magnitude of JAX's
# the margin loss is a hinge, and it divides by the count of active terms:
# a term within bf16 noise of zero (~5e-3 in a distance here) can be on in
# one package and off in the other, which moves the loss by up to 1/8 and
# its gradient by tens of percents whatever the casts
HINGE_CLEARANCE = 0.02


@pytest.fixture(scope="module")
def variables():
    return jax_vit_variables(jax_vit.ViTNetwork(**SMALL), SIZE, 10)


def _jax_model(dtype, narrow):
    return jax_vit.ViTNetwork(**SMALL, dtype=dtype, narrow_sm=narrow)


def _port_model(variables, dtype, narrow):
    return load_jax_params(ViTNetwork(**SMALL, img_size=SIZE, dtype=dtype, narrow_sm=narrow),
                           variables)


@pytest.mark.parametrize("narrow", [False, True], ids=["f32-softmax", "narrow_sm"])
def test_vit_bf16_forward_matches_jax(variables, narrow):
    x = np.random.default_rng(3).standard_normal((4, SIZE, SIZE, 3)).astype(np.float32)
    ref32, ref16 = (jax.jit(lambda v, x, m=m: m.apply(v, x, train=False))(variables, x)
                    for m in (_jax_model(jnp.float32, False), _jax_model(jnp.bfloat16, narrow)))
    model = _port_model(variables, torch.bfloat16, narrow).eval()
    seen = []  # (layer, output dtype): a block's two LayerNorms, then the block
    for name, mod in model.named_modules():
        if name.startswith("block") and name.count(".") <= 1 and "attn" not in name \
                and "mlp" not in name:
            mod.register_forward_hook(
                lambda m, i, o, n=name: seen.append((n, (o[0] if isinstance(o, tuple) else o).dtype)))
    with torch.no_grad():
        ours = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    embed, token_map = ours[0], ours[1][1]
    assert embed.dtype == token_map.dtype == ours[2]["head_tokens"].dtype == torch.float32
    assert ref16[0].dtype == ref16[1][1].dtype == jnp.float32
    assert [d for _, d in seen] == [torch.float32, torch.float32, torch.bfloat16] * SMALL["depth"]
    assert np.all(_cosine(embed, ref16[0]) > COSINE), _cosine(embed, ref16[0])
    gap_jax = np.linalg.norm(_f32(ref16[0]) - _f32(ref32[0]))
    for ref in ref16, ref32:
        gap = np.linalg.norm(_f32(embed) - _f32(ref[0]))
        assert gap < 2 * gap_jax, (gap, gap_jax)


def _port_steps(variables, loss_params, images, dtype, narrow, lrs, arch, n=3):
    """``n`` Adam steps of the port; returns each step's metrics, the
    margin loss's pre-hinge terms before each step, and the model."""
    tm = _port_model(variables, dtype, narrow)
    tl = load_jax_params(MarginLoss(_margin_opt(), _FixedMiner()), {"params": loss_params})
    optim = make_optimizer("adam", 4e-4, build_labels(Config(arch=arch), tm, tl),
                           dict(lrs, fc=-1.0, frozen=0.0))
    tstate = init_train_state(tm, tl, optim, [1000], 0.3, 3)
    x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
    y = torch.from_numpy(LABELS).long()
    a, p, neg = (torch.from_numpy(t) for t in TRIPLETS)
    metrics, terms = [], []
    for _ in range(n):
        with torch.no_grad():
            e = tm.train()(x)[0].float()
            beta = tl.beta[y[a]]
            terms.append(torch.cat([(e[a] - e[p]).norm(dim=1) - beta + tl.margin,
                                    beta - (e[a] - e[neg]).norm(dim=1) + tl.margin]))
        metrics.append({k: float(v) for k, v in train_step(tstate, x, y).items()})
    return metrics, torch.stack(terms), tm


def test_vit_three_bf16_steps_match_jax(variables):
    """Three Adam steps of the bf16 DeiT with the narrowed softmax (the
    card's default) in both packages, the same weights, batch and triplets.
    Measured on the CPU: loss within 2.9e-3 relative, grad_l2 within 1.1e-2
    and grad_max within 1.2e-2 over the three steps; JAX's own bf16 steps
    against its f32 ones: 5.0e-3, 4.2e-3, 6.6e-3.  At weight seed 7 the
    port's loss was 0.96% off, at seed 5 a term 0.006 from its hinge
    flipped in the port's bf16 run only (grad_max 20% off): the margin
    loss divides by its count of active terms."""
    images = np.random.default_rng(6).standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    jl = JaxMarginLoss(_margin_opt(), _JaxFixedMiner())
    loss_params = _host(jl.init_params(jax.random.PRNGKey(1)))
    lrs = {"model": LR, "criterion": 5e-4}
    arch = "vit_small_normalize"
    _, terms, _ = _port_steps(variables, loss_params, images, torch.float32, False, lrs, arch)
    assert terms.abs().min() >= HINGE_CLEARANCE, terms.abs().min()
    labels = jax_build_labels(types.SimpleNamespace(arch=arch, fc_lr=-1.0),
                              variables["params"], loss_params)
    tx = jax_train.make_optimizer("adam", LR, 4e-4, [1000], 0.3, 3, lrs, labels)
    state = jax_train.TrainState(
        params=variables["params"], batch_stats={}, loss_params=loss_params,
        opt_state=tx.init({"model": variables["params"], "criterion": loss_params}),
        step=jnp.zeros((), jnp.int32),
    )
    step_fn = jax_train.make_train_step(_jax_model(jnp.bfloat16, True).apply, jl, tx,
                                        donate=False)
    jax_metrics = []
    for _ in range(3):
        state, m = step_fn(state, jnp.asarray(images), jnp.asarray(LABELS), jax.random.PRNGKey(2))
        jax_metrics.append({k: float(v) for k, v in m.items()})

    ours, _, tm = _port_steps(variables, loss_params, images, torch.bfloat16, True, lrs, arch)
    _check_steps(jax_metrics, ours, tm)


@pytest.mark.parametrize("arch", ["vit_normalize", "deit_small_normalize"])
def test_select_passes_bf16_to_vit(arch):
    """The card's default for the ViT/DeiT arches (bf16 and narrow_sm)
    reaches the model: bf16 layers, the narrowing on, f32 parameters,
    LayerNorms and head."""
    opt = resolve_precision(Config(arch=arch, device="cuda", embed_dim=16))
    with torch.device("meta"):  # full DeiT-S, no values drawn
        m = models.select(arch, opt, img_size=32)
    block = m.block0
    assert m.patch_embed_proj.compute_dtype == block.attn.qkv.compute_dtype == torch.bfloat16
    assert block.mlp.fc2.compute_dtype == torch.bfloat16 and block.attn.narrow_sm
    assert type(m.head) is torch.nn.Linear and type(m.norm) is torch.nn.LayerNorm
    assert all(p.dtype == torch.float32 for p in m.parameters())


def test_train_baseline_vit_bf16_on_cpu(tmp_path, capsys):
    """train_baseline --arch vit_small_normalize with the card's default
    precision asked for on the CPU (--bf16, narrow_sm following it): full
    DeiT-S on a 32 px synthetic set (the model sized from the first test
    batch), one epoch of two steps and the in-train evaluation."""
    out = train_baseline.main([
        "--dataset", "synthetic", "--arch", "vit_small_normalize", "--loss", "margin",
        "--batch_mining", "distance", "--synthetic_size", "32", "--synthetic_classes", "2",
        "--synthetic_per_class", "4", "--bs", "4", "--samples_per_class", "2",
        "--n_epochs", "1", "--evalevery", "1", "--embed_dim", "16", "--device", "cpu",
        "--kernels", "2", "--bf16", "--save_path", str(tmp_path / "runs"),
    ])
    assert "precision: bf16 activations, f32 parameters, narrowed softmax" in capsys.readouterr().out
    assert len(out["step_loss"]) == 2 and all(np.isfinite(out["step_loss"]))
    model = out["state"].model
    assert model.dtype == torch.bfloat16 and model.block0.attn.narrow_sm
    assert all(0.0 <= v <= 100.0 for v in out["eval"][0].values())


def _finals(module, monkeypatch):
    """Record every truncation's final rankings that ``module``'s
    rerank_evaluate hands to metrics_from_ranks."""
    finals = []
    real = module.metrics_from_ranks

    def record(final, *args, **kwargs):
        finals.append(np.asarray(final))
        return real(final, *args, **kwargs)

    monkeypatch.setattr(module, "metrics_from_ranks", record)
    return finals


def test_bf16_qk_evaluation_matches_jax(variables, monkeypatch):
    kw = dict(n_classes=4, per_class=8, size=SIZE, seed=4)
    jm = _jax_model(jnp.bfloat16, False)
    jf = jax_extract_features(jm, variables,
                              JaxLoader(JaxSynthetic(**kw), batch_size=8, num_workers=2),
                              grid_size=GRID, use_qk=True, pad_batch=8)
    tf = extract_features(_port_model(variables, torch.bfloat16, False),
                          DataLoader(SyntheticDataset(**kw), batch_size=8, num_workers=2),
                          grid_size=GRID, use_qk=True, device="cpu")
    for k in ("bank", "center", "q", "k"):
        want = torch.float32 if k in ("bank", "center") else torch.bfloat16
        assert tf[k].dtype == want and str(jf[k].dtype) == str(want).split(".")[1], k
        ours, ref = tf[k].float().numpy(), np.asarray(jf[k], np.float32)
        assert ours.shape == ref.shape, k
        err = np.abs(ours - ref).max() / np.abs(ref).max()
        assert err <= EVAL_TOL, (k, err)
    flags = dict(use_ot=True, qk_scale=1.0 / 8.0)
    ref_finals, our_finals = _finals(jax_rerank_eval, monkeypatch), _finals(rerank_eval, monkeypatch)
    ref = jax_rerank_eval.rerank_evaluate(
        *(jnp.asarray(jf[k]) for k in ("bank", "center", "labels")),
        rollout=jnp.asarray(jf["q"]), rollout_g=jnp.asarray(jf["k"]), trunc_nums=(0, TRUNC),
        method="qk", flags=flags)
    out = rerank_eval.rerank_evaluate(
        *(torch.from_numpy(np.asarray(jf[k])) for k in ("bank", "center", "labels")),
        rollout=torch.from_numpy(np.asarray(jf["q"], np.float32)).bfloat16(),
        rollout_g=torch.from_numpy(np.asarray(jf["k"], np.float32)).bfloat16(),
        trunc_nums=(0, TRUNC), method="qk", flags=flags)
    assert len(our_finals) == len(ref_finals) == 2
    for a, b in zip(our_finals, ref_finals):
        assert np.array_equal(a, b)
    for m in ("r1", "rp", "mapr"):
        for t in (0, TRUNC):
            assert abs(out[m][t] - ref[m][t]) < (1e-4 if m == "mapr" else 1e-9), (m, t)
