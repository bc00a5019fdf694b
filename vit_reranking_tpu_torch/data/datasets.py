"""DML datasets for the port: the procedural synthetic set.

Port of vit_reranking_tpu/data/datasets.py::SyntheticDataset (numpy only, so
the same seed gives the same images as the JAX package) and of ``select`` for
``--dataset synthetic``.  The image-tree datasets (CUB200, Cars196, SOP) come
with a later slice; they will import PIL inside the function that opens a
file.

Contract (of the reference's missing datasets package, reconstructed in the
JAX package): ``image_dict`` (class -> [(path, idx), ...]), ``image_list``
([(path, class), ...]), ``avail_classes``; ``__getitem__`` returns
``(label, image_HWC_float32, index)``.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


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


def select(name: str, opt):
    """Dataset dispatcher: {'training', 'testing', 'evaluation'} splits."""
    if name != "synthetic":
        raise NotImplementedError(f"dataset {name} is not ported yet (synthetic only)")
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
