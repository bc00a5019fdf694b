"""The port's device-resident image pools (``--cache_device``:
data/device_cache.py, engine/extract.py::extract_features_device, the cached
train step and both CLIs) against the JAX package's, on the CPU.

  * the training and evaluation uint8 stores of a written PNG/JPEG tree equal
    the JAX package's bit for bit (the same PIL resize and crop);
  * the augmentation, applied to the draws the JAX package makes from its
    key (``jax.random.split(key, 5)`` and its uniforms), is within 1e-5 of
    JAX's ``cache.augment(key, raw)`` evaluated op by op (measured: 1.1e-6
    at most) for ``base``, ``red`` and ``flip``, uint8 and float stores,
    and the antialiased resize of the flip-only preset (down and up).
    Under ``jax.jit`` XLA fuses the crop's coordinate arithmetic and moves
    its own output by up to 4.5e-5 on uint8 noise, so the bar is held
    against the eager evaluation;
  * the port's draws stay in their ranges;
  * extract_features_device on a small CvT (carried weights, uint8 pool
    with a tail batch) within 1e-5 of JAX's with ``uint8_input``, and
    embed_split's features and labels from the evaluation pool of a written
    tree within 1e-5 of its features from the loader over the same tree;
  * the cached train step is the uncached step on the same augmented batch
    bit for bit, its augmentation drawn before the miner's draws from the
    one generator;
  * train_baseline --cache_device on a synthetic set end to end, and the
    evaluation CLI's metrics with --cache_device within 1e-3 points of the
    uncached run's and of the JAX package's cached run (one small ViT's
    weights in all three; tests/test_device_cache.py's bar).
"""

import copy
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vit_reranking_tpu.cli.test_diml as jax_test_diml
import vit_reranking_tpu.models as jax_models
import vit_reranking_tpu.models.vit as jax_vit
from vit_reranking_tpu.core.config import from_args as jax_from_args
from vit_reranking_tpu.data.datasets import ImageDataset as JaxImageDataset
from vit_reranking_tpu.data.device_cache import (DeviceEvalCache as JaxEvalCache,
                                                 DeviceImageCache as JaxImageCache)
from vit_reranking_tpu.data.transforms import (EvalTransform as JaxEvalTransform,
                                               TrainTransform as JaxTrainTransform)
from vit_reranking_tpu.engine.extract import extract_features_device as jax_extract_device
from vit_reranking_tpu.models.cvt import CvTNetwork as JaxCvT, CvTSpec as JaxSpec

import vit_reranking_tpu_torch.cli.test_diml as test_diml
import vit_reranking_tpu_torch.models as models
from vit_reranking_tpu_torch import losses, miners
from vit_reranking_tpu_torch.cli import train_baseline
from vit_reranking_tpu_torch.core.config import from_args
from vit_reranking_tpu_torch.data.datasets import ImageDataset, _cub200_lists
from vit_reranking_tpu_torch.data.device_cache import DeviceEvalCache, DeviceImageCache
from vit_reranking_tpu_torch.data.transforms import EvalTransform, TrainTransform
from vit_reranking_tpu_torch.data.loader import DataLoader
from vit_reranking_tpu_torch.engine.extract import embed_split, extract_features_device
from vit_reranking_tpu_torch.engine.train import (cached_train_step, init_train_state,
                                                  make_optimizer, train_step)
from vit_reranking_tpu_torch.models.cvt import CvTNetwork, CvTSpec
from vit_reranking_tpu_torch.models.vit import ViTNetwork
from vit_reranking_tpu_torch.weights import load_jax_params

from stand_ins import write_class_tree
from test_torch_vit import jax_vit_variables

torch.set_num_threads(2)

AUG_TOL = 1e-5
EXTRACT_TOL = 1e-5
METRIC_POINTS = 1e-3  # tests/test_device_cache.py:236
SMALL = dict(dim_embed=(16, 32, 64), depth=(1, 1, 1), num_heads=(1, 2, 2))
CVT_SIZE = 64
VIT_SMALL = dict(embed_dim=16, dim=48, depth=2, num_heads=3, patch=8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cub"))
    write_class_tree(root, n_classes=4, per_class=3, seed=3, sides=(40, 90))
    return root


def test_train_store_equals_jax(tree):
    train, _ = _cub200_lists(tree)
    ours = DeviceImageCache.from_dataset(ImageDataset(train, TrainTransform("red")), "cpu",
                                         out_size=24, store_size=32, workers=3)
    ref = JaxImageCache.from_dataset(JaxImageDataset(train, JaxTrainTransform("red")),
                                     out_size=24, store_size=32)
    assert ours.images.dtype == torch.uint8 and ours.images.shape == (6, 32, 32, 3)
    assert np.array_equal(ours.images.numpy(), np.asarray(ref.images))
    assert (ours.augmentation, ours.normalized, ours.out_size) == ("red", False, 24)
    assert ours.nbytes == ref.nbytes == 6 * 32 * 32 * 3
    # without out_size the model's input side is the transform's, as the CLIs build it
    assert DeviceImageCache.from_dataset(ImageDataset(train, TrainTransform("red")), "cpu",
                                         store_size=32).out_size == 224


def test_eval_store_equals_jax(tree):
    _, test = _cub200_lists(tree)
    ours = DeviceEvalCache.from_dataset(ImageDataset(test, EvalTransform(size=32)), "cpu",
                                        workers=2)
    ref = JaxEvalCache.from_dataset(JaxImageDataset(test, JaxEvalTransform(size=32)))
    assert ours.images.dtype == torch.uint8 and not ours.normalized
    assert np.array_equal(ours.images.numpy(), np.asarray(ref.images))
    assert ours.labels.dtype == torch.int32
    assert np.array_equal(ours.labels.numpy(), ref.labels)


def _jax_draws(key, B, S, D, augmentation):
    """The crop and flip the JAX package's augment draws from ``key``
    (vit_reranking_tpu/data/device_cache.py:100-122, 136), as tensors."""
    k_area, k_ratio, k_x, k_y, k_flip = jax.random.split(key, 5)
    if augmentation == "red":
        w = h = jnp.full((B,), float(min(D, S)))
    else:
        area = jax.random.uniform(k_area, (B,), minval=0.08, maxval=1.0)
        logr = jax.random.uniform(k_ratio, (B,), minval=jnp.log(3.0 / 4.0),
                                  maxval=jnp.log(4.0 / 3.0))
        r = jnp.exp(logr)
        w = jnp.clip(jnp.sqrt(area * S * S * r), 8.0, float(S))
        h = jnp.clip(jnp.sqrt(area * S * S / r), 8.0, float(S))
    draws = dict(h=h, w=w, x0=jax.random.uniform(k_x, (B,)) * (S - w),
                 y0=jax.random.uniform(k_y, (B,)) * (S - h),
                 flip=jax.random.bernoulli(k_flip, 0.5, (B,)))
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("augmentation,uint8,S,D", [
    ("base", True, 64, 56),
    ("red", True, 64, 56),
    ("flip", True, 56, 56),
    ("base", False, 64, 56),
    ("base", False, 56, 56),   # a float store at the model's size: flip only
    ("flip", False, 48, 32),   # the resize branch, downscaling (antialiased)
    ("flip", False, 24, 32),   # and upscaling
], ids=["base-uint8", "red-uint8", "flip-uint8", "base-float", "base-float-same-size",
        "flip-resize-down", "flip-resize-up"])
def test_augment_matches_jax(augmentation, uint8, S, D):
    rng = np.random.default_rng(S + D)
    B = 6
    raw = (rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8) if uint8
           else rng.standard_normal((B, S, S, 3)).astype(np.float32))
    ref_cache = JaxImageCache(jnp.asarray(raw), D, augmentation, normalized=not uint8)
    ours = DeviceImageCache(torch.from_numpy(raw), D, augmentation, normalized=not uint8)
    flips = set()
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(key, B, S, D, augmentation)
        flips.update(draws["flip"].tolist())
        ref = np.asarray(ref_cache.augment(key, ref_cache.images))
        out = ours.apply(ours.images, draws)
        assert out.shape == (B, 3, D, D) and out.dtype == torch.float32 and out.is_contiguous()
        err = np.abs(out.permute(0, 2, 3, 1).numpy() - ref).max()
        assert err <= AUG_TOL, (seed, err)
    assert flips == {True, False}


@pytest.mark.parametrize("augmentation", ["base", "red"])
def test_draws_stay_in_range(augmentation):
    S, D, B = 64, 56, 4096
    cache = DeviceImageCache(torch.zeros((1, S, S, 3), dtype=torch.uint8), D, augmentation,
                             normalized=False)
    d = cache.draw(B, torch.Generator().manual_seed(0))
    again = cache.draw(B, torch.Generator().manual_seed(0))
    assert all(torch.equal(d[k], again[k]) for k in d)
    w, h = d["w"], d["h"]
    assert ((w >= 8) & (w <= S) & (h >= 8) & (h <= S)).all()
    assert ((d["x0"] >= 0) & (d["x0"] <= S - w) & (d["y0"] >= 0) & (d["y0"] <= S - h)).all()
    assert 0.4 < d["flip"].float().mean() < 0.6
    if augmentation == "red":
        assert (w == D).all() and (h == D).all()
        return
    free = (w < S) & (h < S)  # neither side clamped: the drawn area and ratio
    area, ratio = (w * h / S ** 2)[free], (w / h)[free]
    eps = 1e-5
    assert ((area >= 0.08 - eps) & (area <= 1 + eps)).all()
    assert ((ratio >= 3 / 4 - eps) & (ratio <= 4 / 3 + eps)).all()
    assert area.min() < 0.1 and area.max() > 0.5 and ratio.min() < 0.8 and ratio.max() > 1.25


def _cvt_tree(shapes, rng):
    """Flax-layout CvT weights drawn with numpy: kernels N(0, 1/fan_in),
    norm scales 1 + 0.1 N, running variances 1 + 0.1 |N|, everything else
    0.02 N (jax.eval_shape sizes them; no init is compiled)."""
    def draw(path, s):
        leaf = path[-1].key
        z = rng.standard_normal(s.shape).astype(np.float32)
        if leaf == "kernel":
            return z * np.float32(np.prod(s.shape[:-1]) ** -0.5)
        if leaf in ("scale", "var"):
            return 1.0 + 0.1 * (np.abs(z) if leaf == "var" else z)
        return 0.02 * z
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def small_cvt():
    jm = JaxCvT(embed_dim=16, spec=JaxSpec(**SMALL))
    x0 = jnp.zeros((2, CVT_SIZE, CVT_SIZE, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: jm.init({"params": k}, x0, train=False),
                            jax.random.PRNGKey(0))
    variables = _cvt_tree(shapes, np.random.default_rng(0))
    tm = load_jax_params(CvTNetwork(embed_dim=16, spec=CvTSpec(**SMALL)), variables).eval()
    return jm, variables, tm


def test_extract_features_device_matches_jax(small_cvt):
    jm, variables, tm = small_cvt
    pool = np.random.default_rng(1).integers(0, 256, (10, CVT_SIZE, CVT_SIZE, 3), dtype=np.uint8)
    ref = jax_extract_device(jm, variables, jnp.asarray(pool), batch_size=4, grid_size=2,
                             uint8_input=True)
    images = torch.from_numpy(pool)
    out = extract_features_device(tm, images, batch_size=4, grid_size=2, uint8_input=True)
    assert set(out) == set(ref) == {"bank", "center"}
    for k in out:
        assert out[k].shape == ref[k].shape
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=EXTRACT_TOL,
                                   err_msg=k)


def test_embed_split_from_the_pool_matches_the_loader(tree, small_cvt):
    """The small CvT over a written tree's test split (6 images, batches of
    4, so a tail batch): from the resident uint8 pool, normalised per
    batch, and from the loader's host transform."""
    _, test = _cub200_lists(tree)
    loader = DataLoader(ImageDataset(test, EvalTransform(size=CVT_SIZE)), batch_size=4,
                        num_workers=1)
    pool = DeviceEvalCache.from_dataset(loader.dataset, "cpu")
    tm = small_cvt[2]
    host = embed_split(tm, loader, None, grid_size=2, device="cpu")
    dev = embed_split(tm, loader, pool, grid_size=2, device="cpu")
    assert set(host) == set(dev) == {"bank", "center", "labels"}
    assert torch.equal(host["labels"].long(), dev["labels"].long())
    for k in ("bank", "center"):
        assert dev[k].shape == host[k].shape
        np.testing.assert_allclose(dev[k].numpy(), host[k].numpy(), rtol=0, atol=EXTRACT_TOL,
                                   err_msg=k)


def _small_state(tm):
    opt = types.SimpleNamespace(n_classes=2, batch_mining="distance",
                                miner_distance_lower_cutoff=0.5, miner_distance_upper_cutoff=1.4)
    crit = losses.select("margin", opt, miners.select("distance", opt))
    optim = make_optimizer("adam", 4e-4, {"model": list(tm.parameters()),
                                          "criterion": list(crit.parameters())},
                           {"model": 1e-4, "criterion": 5e-4})
    return init_train_state(tm, crit, optim)


def test_cached_step_is_the_step_on_the_augmented_batch():
    """On a small ViT (32 px input) from a 40 px uint8 pool."""
    tm = load_jax_params(ViTNetwork(**VIT_SMALL, img_size=32),
                         jax_vit_variables(jax_vit.ViTNetwork(**VIT_SMALL), 32, 1))
    pool = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (12, 40, 40, 3),
                                                              dtype=np.uint8))
    cache = DeviceImageCache(pool, 32, "base", normalized=False)
    idx = torch.tensor([3, 7, 0, 11, 5, 9, 1, 4])
    labels = torch.tensor([0, 0, 1, 1, 0, 0, 1, 1])
    states = [_small_state(copy.deepcopy(tm)) for _ in range(2)]
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    cached = cached_train_step(states[0], cache, idx, labels, gens[0])
    # the augmentation is drawn first, then the miner's draws
    draws = cache.draw(8, gens[1])
    plain = train_step(states[1], cache.apply(pool[idx], draws), labels, gens[1])
    for k in plain:
        assert torch.equal(cached[k], plain[k]), k
    for (n, a), b in zip(states[0].model.named_parameters(), states[1].model.parameters()):
        assert torch.equal(a, b), n


def test_train_baseline_cache_device_on_cpu(tmp_path, capsys):
    """--cache_device through train_baseline: full CvT-13 on a 32 px
    synthetic set, both pools resident (float, flip only), one epoch of two
    steps and the in-train evaluation from the test pool."""
    out = train_baseline.main([
        "--dataset", "synthetic", "--arch", "cvt_13_normalize", "--loss", "margin",
        "--batch_mining", "distance", "--synthetic_size", "32", "--synthetic_classes", "2",
        "--synthetic_per_class", "4", "--bs", "4", "--samples_per_class", "2",
        "--n_epochs", "1", "--evalevery", "1", "--embed_dim", "16", "--device", "cpu",
        "--kernels", "2", "--cache_device", "--save_path", str(tmp_path / "runs"),
    ])
    printed = capsys.readouterr().out
    assert "device image cache: (8, 32, 32, 3) torch.float32" in printed
    assert "device eval cache: (8, 32, 32, 3) torch.float32" in printed
    assert len(out["step_loss"]) == 2 and all(np.isfinite(out["step_loss"]))
    assert len(out["eval"]) == 1 and all(0.0 <= v <= 100.0 for v in out["eval"][0].values())


class _Weighted:
    """A JAX model whose ``init`` returns the given weights (run_eval's
    random init, op by op, would take seconds of compiles here)."""

    def __init__(self, model, variables):
        self.model, self.variables = model, variables

    def init(self, *args, **kwargs):
        return self.variables

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, **kwargs)


def test_cached_eval_cli_matches_uncached_and_jax(tmp_path, monkeypatch):
    """run_eval with and without --cache_device, and the JAX package's with
    it, on one small ViT's weights (embed 16, dim 48, depth 2, patch 8:
    featvit, full OT, exact top-8 reranked, 20 images of 32 px in batches
    of 8, so a tail batch)."""
    jm = jax_vit.ViTNetwork(**VIT_SMALL)
    variables = jax_vit_variables(jm, 32, 2)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax_models, "select", lambda arch, opt: _Weighted(jm, variables))
    monkeypatch.setattr(models, "select", lambda arch, opt, generator=None, img_size=224:
                        ViTNetwork(**VIT_SMALL, img_size=img_size))
    monkeypatch.setattr(test_diml, "load_pretrained_into",
                        lambda opt, m: load_jax_params(m, variables))
    args = ["--dataset", "synthetic", "--synthetic_size", "32", "--synthetic_classes", "4",
            "--synthetic_per_class", "5", "--kernels", "1", "--bs", "8",
            "--arch", "vit_normalize", "--embed_dim", "16", "--use_ot", "--grid_size", "4"]
    opt = from_args(args + ["--device", "cpu"])
    host = test_diml.run_eval(opt, trunc_nums=(0, 8))
    dev = test_diml.run_eval(opt.replace(cache_device=True), trunc_nums=(0, 8))
    ref = jax_test_diml.run_eval(jax_from_args(args + ["--cache_device"]), trunc_nums=(0, 8))
    for k in ("r1", "rp", "mapr"):
        assert set(host[k]) == set(dev[k]) == set(ref[k]) == {0, 8}
        for t in (0, 8):
            assert abs(host[k][t] - dev[k][t]) < METRIC_POINTS, (k, t)
            assert abs(ref[k][t] - dev[k][t]) < METRIC_POINTS, (k, t)
    assert len(open("test_results/test_diml_synthetic.csv").read().splitlines()) == 4
