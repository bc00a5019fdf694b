"""Threaded host-side batch loader.

Port of vit_reranking_tpu/data/loader.py: images are made (or decoded) in a
thread pool while the device computes, and batches come out as stacked numpy
arrays (labels, NHWC float32 images, indices).  Training batches come from a
batch sampler (data/samplers.py).
"""

from __future__ import annotations

import concurrent.futures as cf
import itertools
from typing import Iterator, List, Optional

import numpy as np


PREFETCH = 4  # batches assembled ahead of the consumer


class DataLoader:
    """Iterates (labels, images, indices) batches: the index lists of
    ``batch_sampler`` when one is given, else batches of ``batch_size`` in
    dataset order, the last batch possibly short."""

    def __init__(self, dataset, batch_size: Optional[int] = None, num_workers: int = 8,
                 batch_sampler=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.batch_sampler = batch_sampler
        self.num_workers = max(1, num_workers)

    def iter_index_batches(self) -> Iterator[List[int]]:
        """The index batches alone, no image loaded: the device-resident
        pool's input pipeline (data/device_cache.py) sends each step only
        its indices and labels."""
        if self.batch_sampler is not None:
            yield from self.batch_sampler
            return
        n = len(self.dataset)
        for s in range(0, n, self.batch_size):
            yield list(range(s, min(s + self.batch_size, n)))

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        def fetch(batch_idx):
            items = [self.dataset[i] for i in batch_idx]
            labels = np.asarray([it[0] for it in items], np.int32)
            images = np.stack([it[1] for it in items]).astype(np.float32)
            idxs = np.asarray([it[2] for it in items], np.int32)
            return labels, images, idxs

        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            it = self.iter_index_batches()
            pending = [pool.submit(fetch, b) for b in itertools.islice(it, PREFETCH)]
            for batch_idx in it:
                done = pending.pop(0)
                pending.append(pool.submit(fetch, batch_idx))
                yield done.result()
            for fut in pending:
                yield fut.result()


def build_eval_loaders(opt, splits=None):
    """The evaluation loaders ``{'testing', 'evaluation'}`` for
    ``opt.dataset``, batches of ``opt.bs`` in dataset order."""
    from . import datasets as ds

    splits = splits or ds.select(opt.dataset, opt)
    return {
        name: DataLoader(splits[name], batch_size=opt.bs, num_workers=opt.kernels)
        for name in ("testing", "evaluation")
    }


def build_dataset(opt):
    """``(loaders, train_sampler)`` for ``opt.dataset``, as the JAX package's
    ``build_dataset``: ``loaders`` holds ``training`` (batches from the
    sampler ``opt.data_sampler``) and the loaders of
    :func:`build_eval_loaders`.  Sets ``opt.n_classes`` to the number of
    training classes."""
    from . import datasets as ds
    from . import samplers

    splits = ds.select(opt.dataset, opt)
    train = splits["training"]
    opt.n_classes = len(train.avail_classes)
    sampler = samplers.select(opt.data_sampler, opt, train.image_dict, train.image_list)
    loaders = {"training": DataLoader(train, batch_sampler=sampler, num_workers=opt.kernels)}
    loaders.update(build_eval_loaders(opt, splits))
    return loaders, sampler
