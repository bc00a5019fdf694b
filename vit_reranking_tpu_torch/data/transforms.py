"""Host-side image transforms (PIL + numpy), HWC float32 output.

Port of vit_reranking_tpu/data/transforms.py: the RevisitDML augmentation
presets selected by ``--augmentation`` (reference parameters.py:12-13):
``base`` RandomResizedCrop(224) + flip, ``adv`` adds colour/brightness
jitter, ``big`` 256-crops, ``red`` Resize + RandomCrop.  Evaluation:
Resize(256) + CenterCrop(224); MSLS: ``input_transform``, a bilinear resize
to a fixed (h, w).  Normalisation uses the ImageNet constants.

Every random draw comes from one explicit numpy ``Generator`` in the same
order as the JAX package's, so the same seed gives the same bits.  PIL is
imported inside the functions that use it (the card's host runs the port's
other paths without it).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC ImageNet-normalised."""
    return (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def denormalize(img: np.ndarray) -> np.ndarray:
    """Inverse of :func:`normalize` (reference utilities/diml.py:475-486),
    HWC float -> uint8."""
    return np.clip((img * IMAGENET_STD + IMAGENET_MEAN) * 255.0, 0, 255).astype(np.uint8)


def _resize_short(img, size: int):
    """Bilinear resize of a PIL image so its shorter side is ``size``."""
    from PIL import Image

    w, h = img.size
    if w < h:
        return img.resize((size, int(size * h / w)), Image.BILINEAR)
    return img.resize((int(size * w / h), size), Image.BILINEAR)


def _center_crop(img, size: int):
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def _random_resized_crop(img, size, rng, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop semantics: up to 10 draws of an area and
    log aspect ratio, else the centre crop of the resized image."""
    from PIL import Image

    w, h = img.size
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = rng.uniform(math.log(ratio[0]), math.log(ratio[1]))
        ar = math.exp(log_r)
        cw = int(round(math.sqrt(target * ar)))
        ch = int(round(math.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            return img.crop((left, top, left + cw, top + ch)).resize(
                (size, size), Image.BILINEAR
            )
    return _center_crop(_resize_short(img, size), size)


def _color_jitter(arr: np.ndarray, rng, brightness=0.2, contrast=0.2, saturation=0.2):
    f = arr.astype(np.float32)
    f = f * rng.uniform(1 - brightness, 1 + brightness)
    c = rng.uniform(1 - contrast, 1 + contrast)
    mean = f.mean()
    f = (f - mean) * c + mean
    s = rng.uniform(1 - saturation, 1 + saturation)
    gray = f.mean(axis=-1, keepdims=True)
    f = (f - gray) * s + gray
    return np.clip(f, 0, 255).astype(np.uint8)


class TrainTransform:
    """The training preset ``augmentation`` with its own generator seeded
    with ``seed``.  The generator is shared by every call, so the draws of
    an image depend on the order of the calls: the loader's threads share
    it, as in the JAX package."""

    def __init__(self, augmentation: str = "base", seed: int = 0):
        self.augmentation = augmentation
        self.size = 256 if augmentation == "big" else 224
        self.rng = np.random.default_rng(seed)

    def __call__(self, img) -> np.ndarray:
        img = img.convert("RGB")
        rng = self.rng
        if self.augmentation == "red":
            img = _resize_short(img, 256)
            w, h = img.size
            left = int(rng.integers(0, max(w - self.size, 0) + 1))
            top = int(rng.integers(0, max(h - self.size, 0) + 1))
            img = img.crop((left, top, left + self.size, top + self.size))
        else:
            img = _random_resized_crop(img, self.size, rng)
        arr = np.asarray(img)
        if self.augmentation == "adv":
            arr = _color_jitter(arr, rng)
        if rng.random() < 0.5:
            arr = arr[:, ::-1]
        return normalize(np.ascontiguousarray(arr))


class EvalTransform:
    """Resize the shorter side to ``size * 256 / 224``, centre-crop
    ``size`` (224, or 256 for ``big``)."""

    def __init__(self, augmentation: str = "base", size: Optional[int] = None):
        self.size = size or (256 if augmentation == "big" else 224)

    def __call__(self, img) -> np.ndarray:
        img = img.convert("RGB")
        img = _center_crop(_resize_short(img, int(self.size * 256 / 224)), self.size)
        return normalize(np.asarray(img))


def input_transform(resize=(480, 640)):
    """MSLS's fixed-size transform (reference training_tools/msls.py,
    ``input_transform(resize=(h, w))``): RGB, a bilinear resize to (h, w),
    then :func:`normalize`.  The function keeps ``resize`` as ``.resize``."""

    def fn(img) -> np.ndarray:
        from PIL import Image

        img = img.convert("RGB").resize((resize[1], resize[0]), Image.BILINEAR)
        return normalize(np.asarray(img))

    fn.resize = resize
    return fn
