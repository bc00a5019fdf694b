"""Batch samplers: host-side index batches from a reproducible numpy RNG.

Port of vit_reranking_tpu/data/samplers.py for the canonical
``class_random`` sampler (reference datasampler/class_random_sampler.py:
12-49).  The draws are numpy ``default_rng(seed)`` exactly as in the JAX
package, so both packages train on the same index batches.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class ClassRandomSampler:
    """SPC-N class sampling: each batch is ``bs / samples_per_class`` random
    classes with ``samples_per_class`` random members each."""

    REQUIRES_STORAGE = False

    def __init__(self, opt, image_dict, image_list, seed: Optional[int] = None, **kw):
        self.image_dict = image_dict
        self.image_list = image_list
        self.classes = list(image_dict.keys())
        self.batch_size = opt.bs
        self.samples_per_class = opt.samples_per_class
        self.sampler_length = len(image_list) // opt.bs
        if self.batch_size % self.samples_per_class:
            raise ValueError("#Samples per class must divide batchsize!")
        self.rng = np.random.default_rng(seed if seed is not None else opt.seed)
        self.name = "class_random_sampler"
        self.requires_storage = False

    def __iter__(self):
        for _ in range(self.sampler_length):
            subset: List[int] = []
            for _ in range(self.batch_size // self.samples_per_class):
                cls = self.classes[self.rng.integers(len(self.classes))]
                members = self.image_dict[cls]
                picks = self.rng.integers(len(members), size=self.samples_per_class)
                subset.extend(members[p][-1] for p in picks)
            yield subset

    def __len__(self):
        return self.sampler_length


SAMPLERS = {"class_random": ClassRandomSampler}


def select(name: str, opt, image_dict, image_list, **kw):
    """Sampler dispatcher (dsamplers.select, train_diml.py:116)."""
    key = name.replace("_sampler", "")
    if key not in SAMPLERS:
        raise NotImplementedError(f"datasampler {name} is not ported yet (class_random only)")
    return SAMPLERS[key](opt, image_dict, image_list, **kw)
