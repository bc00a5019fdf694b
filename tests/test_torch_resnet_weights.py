"""The port's ResNet-50 on real trained weights: the repo's checkpoint
Training_Results/synthetic/parity_rn_no-bf16_s23/best (``resnet50_normalize``
trained 3 epochs in f32 by the JAX package: margin loss, distance mining,
batch 32, the synthetic set of 8 classes x 16 images at 224 px, seed 23),
restored with the JAX package's own ``core/checkpoint.py::load_checkpoint``
and loaded into the port's f32 model through ``weights.load_jax_params``.

The port's train_baseline in-train evaluation (embed, N x N cosine, R@1 /
RP / MAP@R) of seed 23's 128-image test split is held against the JAX
package's own in-train evaluation of the same checkpoint on the CPU.  Both
reproduce the run's ``best.metrics.json`` (R@1 100.0, RP 93.65234375, MAP@R
93.6394989...) to the last digit on this CPU: the metrics there were written
by the same arithmetic, whatever device trained the weights.
"""

import json
import os

import numpy as np
import jax
import pytest
import torch

import vit_reranking_tpu.cli.train_baseline as jax_train_baseline
from vit_reranking_tpu.core.checkpoint import load_checkpoint
from vit_reranking_tpu.core.config import Config as JaxConfig
from vit_reranking_tpu.data.loader import build_dataset as jax_build_dataset
from vit_reranking_tpu.models.resnet import ResNet50Network as JaxResNet50Network

from vit_reranking_tpu_torch.cli import train_baseline
from vit_reranking_tpu_torch.core.config import Config
from vit_reranking_tpu_torch.data.loader import build_eval_loaders
from vit_reranking_tpu_torch.models.resnet import ResNet50Network
from vit_reranking_tpu_torch.weights import load_jax_params

torch.set_num_threads(2)

RUN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "Training_Results", "synthetic", "parity_rn_no-bf16_s23")
# the run's data (its Parameter_Info.txt)
DATA = dict(dataset="synthetic", seed=23, synthetic_classes=8, synthetic_per_class=16,
            synthetic_size=224, bs=32, kernels=2)


@pytest.fixture(scope="module")
def evaluations(monkeypatch_module):
    """Both packages' in-train evaluations of ``best``, with the embeddings
    each computed on the way (captured from its extraction)."""
    ckpt = load_checkpoint(os.path.join(RUN, "best"))
    variables = {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]}
    captured = {}

    def capture(key, real):
        def spy(*a, **kw):
            captured[key] = real(*a, **kw)
            return captured[key]
        return spy

    monkeypatch_module.setattr(train_baseline, "embed_split",
                               capture("port", train_baseline.embed_split))
    monkeypatch_module.setattr(jax_train_baseline, "extract_features",
                               capture("jax", jax_train_baseline.extract_features))
    with torch.device("meta"):
        model = ResNet50Network(embed_dim=128)
    model = load_jax_params(model.to_empty(device="cpu"), jax.tree.map(np.asarray, variables))
    loader = build_eval_loaders(Config(device="cpu", **DATA))["testing"]
    port = train_baseline.evaluate_plain(model, loader, torch.device("cpu"))
    loaders, _ = jax_build_dataset(JaxConfig(**DATA))
    ref = jax_train_baseline.evaluate_plain(JaxResNet50Network(embed_dim=128), variables,
                                            loaders["testing"], pad_batch=32)
    return port, {k: float(v) for k, v in ref.items()}, captured


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_trained_resnet_metrics_match_jax_and_the_run(evaluations):
    """R@1, RP and MAP@R within 0.1 point of the JAX package's evaluation,
    and of the run's best.metrics.json (both are equal to it here)."""
    port, ref, _ = evaluations
    with open(os.path.join(RUN, "best.metrics.json")) as f:
        saved = json.load(f)
    for k in ("r1", "rp", "mapr"):
        assert abs(port[k] - ref[k]) <= 0.1, (k, port[k], ref[k])
        assert abs(port[k] - saved[k]) <= 0.1, (k, port[k], saved[k])


def test_trained_resnet_embeddings_match_jax(evaluations):
    """The 128 L2-normed embeddings within 1e-4 (measured ~3e-7)."""
    _, _, captured = evaluations
    port, ref = captured["port"], captured["jax"]
    assert port["center"].shape == (128, 128)
    np.testing.assert_allclose(port["center"].numpy(), np.asarray(ref["center"]), atol=1e-4)
    np.testing.assert_array_equal(port["labels"].numpy(), np.asarray(ref["labels"]))


def test_trained_resnet_rankings_match_jax(evaluations):
    """Each query's ranking over the 15 places the metrics read (its class
    has 15 other images) lists the same labels in both packages, and where
    the two orders name different images the two similarities are within
    1e-6 (same-class near-duplicates tied at f32 rounding)."""
    _, _, captured = evaluations
    labels = captured["port"]["labels"].numpy()
    sims = []
    for key in ("port", "jax"):
        c = np.asarray(captured[key]["center"], np.float64)
        s = c @ c.T
        np.fill_diagonal(s, -np.inf)
        sims.append(s)
    ranks = [np.argsort(-s, axis=1, kind="stable")[:, :15] for s in sims]
    np.testing.assert_array_equal(labels[ranks[0]], labels[ranks[1]])
    q, k = np.nonzero(ranks[0] != ranks[1])
    gaps = np.abs(sims[1][q, ranks[0][q, k]] - sims[1][q, ranks[1][q, k]])
    assert gaps.size == 0 or gaps.max() <= 1e-6, gaps.max()
