"""DML datasets for the port: CUB200, Cars196, Stanford Online Products
and the procedural synthetic set.

Port of vit_reranking_tpu/data/datasets.py: the image trees' lists,
``ImageDataset`` and ``SyntheticDataset`` (numpy only, so the same seed gives
the same images as the JAX package), and ``select``.  PIL is imported inside
the method that opens a file.

Contract (of the reference's missing datasets package, reconstructed in the
JAX package): ``image_dict`` (class -> [(path, idx), ...]), ``image_list``
([(path, class), ...]), ``avail_classes``; ``__getitem__`` returns
``(label, image_HWC_float32, index)``.  Splits follow RevisitDML: the first
half of the classes trains, the second half tests (CUB 100/100, Cars
98/98; SOP by its ``Ebay_train.txt`` / ``Ebay_test.txt``), and the
``evaluation`` split is the training list under the evaluation transform.

The training split's ``TrainTransform`` holds one generator that the
loader's threads share (data/loader.py), so which image gets which draws
depends on the order in which the threads reach it, as in the JAX package.
The same seed gives the same images only in index order: one loader thread
(``--kernels 1``) or calls in order.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .transforms import EvalTransform, TrainTransform


class ImageDataset:
    """Path-list dataset with the reference's attribute contract:
    ``image_list`` [(path, class), ...] decoded by PIL and passed through
    ``transform``."""

    def __init__(self, image_list, transform):
        self.image_list = list(image_list)
        self.transform = transform
        image_dict: Dict[int, List[Tuple[str, int]]] = defaultdict(list)
        for idx, (path, cls) in enumerate(self.image_list):
            image_dict[cls].append((path, idx))
        self.image_dict = dict(image_dict)
        self.avail_classes = sorted(self.image_dict)

    def __len__(self):
        return len(self.image_list)

    def load_image(self, idx: int) -> np.ndarray:
        from PIL import Image

        with Image.open(self.image_list[idx][0]) as img:
            return self.transform(img)

    def __getitem__(self, idx: int):
        return self.image_list[idx][1], self.load_image(idx), idx


class SyntheticDataset:
    """Procedural dataset: each class is a distinct smooth color/texture
    pattern + noise; separable enough that retrieval metrics are meaningful.

    ``sep`` < 1 shrinks every class prototype toward one shared prototype and
    adds a per-image random gain/shift nuisance; ``sep=1.0`` (default) draws
    no shared prototype, leaving the prototype RNG stream untouched."""

    def __init__(self, n_classes=8, per_class=16, size=224, seed=0, sep=1.0,
                 noise=0.35, nuisance=1.0):
        self.size = size
        self.seed = seed
        self.sep = float(sep)
        self.noise = float(noise)
        self.nuisance = float(nuisance)
        self.image_list = [(None, c) for c in range(n_classes) for _ in range(per_class)]
        image_dict = defaultdict(list)
        for idx, (path, cls) in enumerate(self.image_list):
            image_dict[cls].append((path, idx))
        self.image_dict = dict(image_dict)
        self.avail_classes = sorted(self.image_dict)
        rng = np.random.default_rng(seed)
        protos = rng.uniform(-1, 1, (n_classes, 4, 4, 3))
        if self.sep != 1.0:
            shared = rng.uniform(-1, 1, (1, 4, 4, 3))
            protos = shared + self.sep * (protos - shared)
        self._protos = protos.astype(np.float32)

    def __len__(self):
        return len(self.image_list)

    def load_image(self, idx: int) -> np.ndarray:
        cls = self.image_list[idx][1]
        rng = np.random.default_rng(self.seed * 100003 + idx)
        base = self._protos[cls]
        img = np.kron(base, np.ones((self.size // 4, self.size // 4, 1), np.float32))
        img = img + self.noise * rng.standard_normal(img.shape).astype(np.float32)
        if self.sep != 1.0:
            # per-image global gain/shift nuisance, shared across classes
            gain = 1.0 + 0.25 * self.nuisance * rng.standard_normal()
            shift = 0.3 * self.nuisance * rng.standard_normal((1, 1, 3))
            img = gain * img + shift.astype(np.float32)
        return img.astype(np.float32)

    def __getitem__(self, idx: int):
        return self.image_list[idx][1], self.load_image(idx), idx


def _cub200_lists(source_path: str):
    """Per-class directories under ``images/`` (sorted), JPEG/PNG files in
    each (sorted); the first half of the classes trains, each half's
    classes numbered from 0."""
    img_root = os.path.join(source_path, "images")
    classes = sorted(os.listdir(img_root))
    files = {
        c: sorted(
            os.path.join(img_root, c, f)
            for f in os.listdir(os.path.join(img_root, c))
            if f.lower().endswith((".jpg", ".jpeg", ".png"))
        )
        for c in classes
    }

    def listed(cs):
        return [(p, ci) for ci, c in enumerate(cs) for p in files[c]]

    half = len(classes) // 2
    return listed(classes[:half]), listed(classes[half:])


def _cars196_lists(source_path: str):
    """Cars196 in the same per-class layout as CUB200."""
    if not os.path.isdir(os.path.join(source_path, "images")):
        raise FileNotFoundError(f"cars196 images/ not found under {source_path}")
    return _cub200_lists(source_path)


def _sop_lists(source_path: str):
    """``Ebay_train.txt`` / ``Ebay_test.txt`` (a header line, then
    ``image_id class_id super_class_id path``), each split's class ids
    remapped to 0-based contiguous ones in sorted order."""

    def parse(fname):
        out = []
        with open(os.path.join(source_path, fname)) as f:
            next(f)  # header
            for line in f:
                _, class_id, _, path = line.strip().split(" ")
                out.append((os.path.join(source_path, path), int(class_id) - 1))
        remap = {c: i for i, c in enumerate(sorted({c for _, c in out}))}
        return [(p, remap[c]) for p, c in out]

    return parse("Ebay_train.txt"), parse("Ebay_test.txt")


IMAGE_TREES = {"cub200": _cub200_lists, "cars196": _cars196_lists,
               "online_products": _sop_lists}


def select(name: str, opt, source_path: Optional[str] = None):
    """Dataset dispatcher: {'training', 'testing', 'evaluation'} splits.
    An image tree is read from ``source_path``, by default
    ``opt.source_path/<name>``."""
    if name in IMAGE_TREES:
        tr, te = IMAGE_TREES[name](source_path or os.path.join(opt.source_path, name))
        return {
            "training": ImageDataset(tr, TrainTransform(opt.augmentation, opt.seed)),
            "testing": ImageDataset(te, EvalTransform(opt.augmentation)),
            "evaluation": ImageDataset(tr, EvalTransform(opt.augmentation)),
        }
    if name != "synthetic":
        raise NotImplementedError(f"dataset {name} unknown")
    kw = dict(
        n_classes=opt.synthetic_classes, per_class=opt.synthetic_per_class,
        size=opt.synthetic_size, sep=opt.synthetic_sep, noise=opt.synthetic_noise,
        nuisance=opt.synthetic_nuisance,
    )
    return {
        "training": SyntheticDataset(seed=opt.seed, **kw),
        "testing": SyntheticDataset(seed=opt.seed + 1, **kw),
        "evaluation": SyntheticDataset(seed=opt.seed, **kw),
    }
