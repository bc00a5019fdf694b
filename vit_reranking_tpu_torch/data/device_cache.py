"""Device-resident image pools and on-device augmentation.

Port of vit_reranking_tpu/data/device_cache.py::DeviceImageCache and
DeviceEvalCache (``--cache_device``).  A split's images are loaded once, as
uint8, into the card's memory.  In training the host then sends only each
batch's indices and labels: the step gathers the raw batch from the pool
and does the random resized crop, the flip and the normalisation on the
device (engine/train.py::cached_train_step).  In evaluation the embedding
runs over the resident pool (engine/extract.py::extract_features_device).

Deviations from the host transforms (data/transforms.py), the JAX package's
own: the crop is drawn once and clamped instead of torchvision's ten tries;
it is taken from a short-side-256, centre-cropped store rather than the
original image; it is resampled bilinearly on the device rather than by
PIL; ``adv``'s colour jitter is not done (its crop and flip are).  Scale and
ratio follow the same distributions.  The draws come from a
``torch.Generator``, so they differ from the JAX package's by construction.

PIL is imported inside the function that reads the files.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .transforms import IMAGENET_MEAN, IMAGENET_STD


class PixelNormalizer:
    """uint8 pixel values (as float32, NCHW) -> ImageNet-normalised values
    on one device, bit for bit as data/transforms.py::normalize computes
    them on the host.  Its constants go to the device once, so a step that
    uses it copies nothing from the host; 255 is a tensor there, since a
    CUDA tensor divided by a Python number is multiplied by its reciprocal
    instead, a bit off in some pixels."""

    def __init__(self, device):
        self.scale = torch.full((), 255.0, device=device)
        self.mean = torch.as_tensor(IMAGENET_MEAN, device=device).view(1, 3, 1, 1)
        self.std = torch.as_tensor(IMAGENET_STD, device=device).view(1, 3, 1, 1)

    def unit(self, x: torch.Tensor) -> torch.Tensor:
        """Pixel values -> [0, 1]."""
        return x / self.scale

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """[0, 1] -> ImageNet-normalised."""
        return (x - self.mean) / self.std

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.normalize(self.unit(x))


def _photo_store(image_list, resize: int, crop: int, workers: int) -> np.ndarray:
    """(N, crop, crop, 3) uint8: each file's shorter side resized to
    ``resize``, then centre-cropped to ``crop``, read in ``workers``
    threads in list order."""
    from PIL import Image

    from .transforms import _center_crop, _resize_short

    def load(path):
        with Image.open(path) as img:
            return np.asarray(_center_crop(_resize_short(img.convert("RGB"), resize), crop),
                              np.uint8)

    stack = np.empty((len(image_list), crop, crop, 3), np.uint8)
    with cf.ThreadPoolExecutor(max(1, workers)) as pool:
        for i, arr in enumerate(pool.map(load, [p for p, _ in image_list])):
            stack[i] = arr
    return stack


def _float_store(dataset) -> np.ndarray:
    """A dataset without a transform (synthetic), stored as its loader emits
    it: (N, H, W, 3) float32 pixel values."""
    return np.stack([dataset.load_image(i) for i in range(len(dataset))]).astype(np.float32)


class _ResidentPool:
    """A split's images resident on a device, ``images`` (N, H, W, 3):
    uint8, or float32 final pixel values (``normalized``); ``kind`` names
    it where the CLIs print its size."""

    kind: str
    images: torch.Tensor
    normalized: bool

    @property
    def nbytes(self) -> int:
        return self.images.numel() * self.images.element_size()


class DeviceImageCache(_ResidentPool):
    """Raw training images resident on a device, and the augmentation that
    turns a gathered batch of them into the model's input.

    ``images`` is (N, S, S, 3): uint8 for photo datasets, float32 for
    datasets whose loader already emits final pixel values (synthetic), which
    get the flip only (``normalized``).  :meth:`draw` draws a batch's crop
    and flip from a generator on the pool's device, :meth:`apply` applies
    them; :meth:`augment` does both."""

    kind = "device image cache"

    def __init__(self, images: torch.Tensor, out_size: int, augmentation: str,
                 normalized: bool):
        self.images = images
        self.out_size = out_size
        self.augmentation = augmentation
        self.normalized = normalized
        self.pixels = PixelNormalizer(images.device)

    @classmethod
    def from_dataset(cls, dataset, device, out_size: Optional[int] = None,
                     store_size: int = 256, workers: int = 1) -> "DeviceImageCache":
        """Load every image of ``dataset`` once onto ``device``: photo
        datasets (``dataset.transform`` set) as uint8 at ``store_size``
        (short-side resize and centre crop), with the transform's
        augmentation preset; others as their float values, flip only.
        ``out_size`` is the model's input side (default the transform's
        ``size``, else the store's)."""
        out_size = out_size or getattr(getattr(dataset, "transform", None), "size", None)
        if getattr(dataset, "transform", None) is not None:
            stack = _photo_store(dataset.image_list, store_size, store_size, workers)
            augmentation = getattr(dataset.transform, "augmentation", "base")
            normalized = False
        else:
            stack = _float_store(dataset)
            augmentation, normalized = "flip", True
        images = torch.from_numpy(stack).to(device)
        return cls(images, out_size or images.shape[1], augmentation, normalized)

    def draw(self, batch: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """A batch's augmentation, drawn on the pool's device: the crop's
        height ``h`` and width ``w`` (RandomResizedCrop: area U(0.08, 1) of
        the store, log aspect ratio U(log 3/4, log 4/3), each side clamped to
        [8, S]; ``red``: min(D, S) square), its corner ``y0``, ``x0`` uniform
        over the store, and ``flip`` (probability 1/2)."""
        S, D = self.images.shape[1], self.out_size
        u = torch.rand((5, batch), generator=generator, device=self.images.device)
        if self.augmentation == "red":
            w = h = torch.full((batch,), float(min(D, S)), device=u.device)
        else:
            area = 0.08 + (1.0 - 0.08) * u[0]
            lo, hi = math.log(3.0 / 4.0), math.log(4.0 / 3.0)
            r = torch.exp(lo + (hi - lo) * u[1])
            w = torch.sqrt(area * S * S * r).clamp(8.0, float(S))
            h = torch.sqrt(area * S * S / r).clamp(8.0, float(S))
        return {"h": h, "w": w, "x0": u[2] * (S - w), "y0": u[3] * (S - h), "flip": u[4] < 0.5}

    def apply(self, raw: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, S, S, 3) gathered pool rows -> (B, 3, D, D) float32 model
        input: the crop of ``draws`` resampled bilinearly to D x D with the
        weights of ``jax.image.scale_and_translate(bilinear,
        antialias=False)``, or, for the flip-only preset on a store of
        another size, an antialiased bilinear resize (``jax.image.resize``);
        then the flip, then the normalisation of uint8 stores."""
        D, S = self.out_size, raw.shape[1]
        x = raw.permute(0, 3, 1, 2).float()
        if not self.normalized:
            x = self.pixels.unit(x)
        if self.augmentation != "flip" and not (self.normalized and S == D):
            x = _crop_resize(x, draws, D)
        elif S != D:
            x = F.interpolate(x, size=(D, D), mode="bilinear", align_corners=False,
                              antialias=True)
        x = torch.where(draws["flip"][:, None, None, None], x.flip(-1), x)
        if not self.normalized:
            x = self.pixels.normalize(x)
        return x.contiguous()

    def augment(self, raw: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return self.apply(raw, self.draw(raw.shape[0], generator))


def _axis_weights(start: torch.Tensor, size: torch.Tensor, S: int, D: int):
    """Along one axis, for each image's window [start, start + size) of S
    input pixels resampled to D: the two input pixels each output pixel
    reads, (B, D) each, and their weights, computed as
    ``jax.image.scale_and_translate(bilinear, antialias=False)`` computes
    its weight matrix (the triangle kernel at the output pixel centre's
    input coordinate, renormalised over the pixels inside the input, zero
    for a centre outside it), so both packages weigh alike."""
    # divisions of tensors (``D / size`` would multiply by the reciprocal)
    scale = torch.full_like(size, D) / size
    inv = torch.ones_like(scale) / scale
    trans = -start * D / size
    centre = torch.arange(D, device=start.device, dtype=torch.float32) + 0.5
    s = centre[None] * inv[:, None] - (trans * inv)[:, None] - 0.5
    lo = torch.floor(s)
    idx, weights = [], []
    for j in (lo, lo + 1.0):
        inside = (j >= 0) & (j <= S - 1)
        weights.append(torch.where(inside, torch.clamp(1.0 - torch.abs(s - j), min=0.0), 0.0))
        idx.append(j.clamp(0, S - 1).long())
    total = weights[0] + weights[1]
    keep = (total.abs() > 1000.0 * torch.finfo(torch.float32).eps) & (s >= -0.5) & (s <= S - 0.5)
    weights = [torch.where(keep, w / torch.where(total != 0, total, 1.0), 0.0) for w in weights]
    return idx, weights


def _crop_resize(x: torch.Tensor, draws: Dict[str, torch.Tensor], D: int) -> torch.Tensor:
    """Each image's (y0, x0, h, w) window of ``x`` (B, C, S, S) resampled
    bilinearly to D x D, rows then columns, each output value the weighted
    sum of the two input values :func:`_axis_weights` names."""
    B, C, S = x.shape[0], x.shape[1], x.shape[-1]
    (r0, r1), (a0, a1) = _axis_weights(draws["y0"], draws["h"], S, D)
    rows = lambda r: x.gather(2, r.view(B, 1, D, 1).expand(B, C, D, S))
    x = rows(r0) * a0.view(B, 1, D, 1) + rows(r1) * a1.view(B, 1, D, 1)
    (c0, c1), (b0, b1) = _axis_weights(draws["x0"], draws["w"], S, D)
    cols = lambda c: x.gather(3, c.view(B, 1, 1, D).expand(B, C, D, D))
    return cols(c0) * b0.view(B, 1, 1, D) + cols(c1) * b1.view(B, 1, 1, D)


class DeviceEvalCache(_ResidentPool):
    """A test split resident on a device for the evaluations: photo
    datasets store the evaluation transform's crop (short side to
    ``size * 256 / 224``, centre crop ``size``) as uint8, normalised per
    batch by the extraction; synthetic datasets store their final float
    values (``normalized``).  ``labels`` is an int32 tensor on the same
    device."""

    kind = "device eval cache"

    def __init__(self, images: torch.Tensor, labels: torch.Tensor, normalized: bool):
        self.images = images
        self.labels = labels
        self.normalized = normalized

    @classmethod
    def from_dataset(cls, dataset, device, workers: int = 1) -> "DeviceEvalCache":
        tf = getattr(dataset, "transform", None)
        if tf is None:
            stack, normalized = _float_store(dataset), True
        else:
            stack = _photo_store(dataset.image_list, int(tf.size * 256 / 224), tf.size, workers)
            normalized = False
        labels = np.asarray([c for _, c in dataset.image_list], np.int32)
        return cls(torch.from_numpy(stack).to(device), torch.from_numpy(labels).to(device),
                   normalized)
