"""The port's image-tree datasets, transforms and loaders
(vit_reranking_tpu_torch/data/) against the JAX package's, on the CPU.

Trees in the CUB200, Cars196 and SOP layouts are written from a seed (small
JPEG and PNG files of odd sides, mixed aspect ratios); on each:

  * ``image_list``, ``image_dict`` and ``avail_classes`` of every split are
    equal;
  * the evaluation transform's images are the same bits;
  * the training transform's images are the same bits for each preset
    (``base``, ``adv``, ``big``, ``red``) from the same seed, the dataset
    called in index order (its generator is shared by the loader's threads
    in both packages, so only an ordered run is reproducible);
  * the loaders' batches are equal with one loader thread.
"""

import os

import numpy as np
import pytest

from vit_reranking_tpu.core.config import Config as JaxConfig
from vit_reranking_tpu.data import datasets as jax_datasets
from vit_reranking_tpu.data import transforms as jax_transforms
from vit_reranking_tpu.data.loader import build_dataset as jax_build_dataset

from vit_reranking_tpu_torch.core.config import Config
from vit_reranking_tpu_torch.data import datasets, transforms
from vit_reranking_tpu_torch.data.loader import build_dataset, build_eval_loaders

from stand_ins import write_class_tree, write_sop_tree

LAYOUTS = ("cub200", "cars196", "online_products")
PRESETS = ("base", "adv", "big", "red")


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """One tree of each layout under a common source path."""
    root = tmp_path_factory.mktemp("data")
    write_class_tree(str(root / "cub200"), n_classes=4, per_class=3, seed=1)
    write_class_tree(str(root / "cars196"), n_classes=5, per_class=2, seed=2,
                     sides=(17, 45))
    write_sop_tree(str(root / "online_products"), n_train=4, n_test=4, per_class=2, seed=3)
    return str(root)


def _opts(source, name, **kw):
    common = dict(dataset=name, source_path=source, bs=4, kernels=1, seed=5,
                  samples_per_class=2, **kw)
    return JaxConfig(**common), Config(device="cpu", **common)


@pytest.mark.parametrize("name", LAYOUTS)
def test_lists_match_jax(source, name):
    jopt, opt = _opts(source, name)
    ref = jax_datasets.select(name, jopt)
    ours = datasets.select(name, opt)
    for split in ("training", "testing", "evaluation"):
        assert ours[split].image_list == ref[split].image_list, split
        assert ours[split].image_dict == ref[split].image_dict, split
        assert ours[split].avail_classes == ref[split].avail_classes, split
        assert len(ours[split]) == len(ref[split]) > 0
    # every split's classes are numbered from 0, contiguous
    assert ours["testing"].avail_classes == list(range(len(ours["testing"].avail_classes)))


def test_select_source_path_and_unknown_name(source):
    _, opt = _opts(source, "cub200")
    explicit = datasets.select("cub200", opt.replace(source_path="/nonexistent"),
                               os.path.join(source, "cub200"))
    assert explicit["training"].image_list == datasets.select("cub200", opt)["training"].image_list
    with pytest.raises(FileNotFoundError):
        datasets.select("cars196", opt.replace(source_path=os.path.join(source, "cub200")))
    with pytest.raises(NotImplementedError, match="inshop"):
        datasets.select("inshop", opt)


@pytest.mark.parametrize("name", LAYOUTS)
def test_eval_transform_bitwise(source, name):
    jopt, opt = _opts(source, name)
    ref = jax_datasets.select(name, jopt)
    ours = datasets.select(name, opt)
    for split in ("testing", "evaluation"):
        for i in range(len(ours[split])):
            lab, img, idx = ours[split][i]
            rlab, rimg, ridx = ref[split][i]
            assert (lab, idx) == (rlab, ridx)
            assert img.dtype == np.float32 and img.shape == (224, 224, 3)
            np.testing.assert_array_equal(img, rimg)


@pytest.mark.parametrize("preset", PRESETS)
def test_train_transform_bitwise(source, preset):
    """Each preset from the same seed, on CUB and SOP, in index order; a
    second pass goes on with the generator's stream."""
    for name in ("cub200", "online_products"):
        jopt, opt = _opts(source, name, augmentation=preset)
        ref = jax_datasets.select(name, jopt)["training"]
        ours = datasets.select(name, opt)["training"]
        side = 256 if preset == "big" else 224
        for _ in range(2):
            for i in range(len(ours)):
                img = ours[i][1]
                assert img.shape == (side, side, 3)
                np.testing.assert_array_equal(img, ref[i][1], err_msg=f"{name} {i}")


def test_transform_helpers_bitwise():
    """The helpers on one odd-sized image, with every branch of the random
    crop (a crop found, and the fallback when no draw fits)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 256, (37, 91, 3), dtype=np.uint8))
    arr = np.asarray(img)
    np.testing.assert_array_equal(transforms.normalize(arr), jax_transforms.normalize(arr))
    for size in (24, 224):
        a = transforms._center_crop(transforms._resize_short(img, size), size)
        b = jax_transforms._center_crop(jax_transforms._resize_short(img, size), size)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for scale in ((0.08, 1.0), (50.0, 60.0)):  # the second never fits: the fallback
        a = transforms._random_resized_crop(img, 64, np.random.default_rng(3), scale=scale)
        b = jax_transforms._random_resized_crop(img, 64, np.random.default_rng(3), scale=scale)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        transforms._color_jitter(arr, np.random.default_rng(4)),
        jax_transforms._color_jitter(arr, np.random.default_rng(4)))


@pytest.mark.parametrize("name", ("cub200", "online_products"))
def test_loader_batches_match_jax(source, name):
    """build_dataset with one loader thread: the training batches (class
    sampler, training transform) and both evaluation loaders' batches are
    equal, and n_classes is set from the training split."""
    jopt, opt = _opts(source, name, augmentation="adv")
    ref_loaders, _ = jax_build_dataset(jopt)
    loaders, _ = build_dataset(opt)
    assert opt.n_classes == jopt.n_classes == len(loaders["training"].dataset.avail_classes)
    for split in ("training", "testing", "evaluation"):
        ours, ref = list(loaders[split]), list(ref_loaders[split])
        assert len(ours) == len(ref) == len(loaders[split]) > 0, split
        for (lab, img, idx), (rlab, rimg, ridx) in zip(ours, ref):
            np.testing.assert_array_equal(lab, rlab)
            np.testing.assert_array_equal(idx, ridx)
            np.testing.assert_array_equal(img, rimg)
    eval_loaders = build_eval_loaders(opt)
    assert sorted(eval_loaders) == ["evaluation", "testing"]
    assert eval_loaders["testing"].dataset.image_list == loaders["testing"].dataset.image_list
