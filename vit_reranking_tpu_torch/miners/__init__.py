"""Batch miners — vectorized, device-resident triplet sampling.

Port of vit_reranking_tpu/miners/__init__.py for the ``distance`` miner; the
other miners come with later slices.  A miner is a callable
``miner(embeddings, labels, generator=None) -> Triplets`` that draws from the
same distribution as the JAX package's, from a ``torch.Generator`` instead of
a JAX key (the two give different numbers).
"""

from . import distance
from .common import Triplets, pdist

BATCHMINING_METHODS = {"distance": distance}


def select(name, opt):
    """reference batchminer/__init__.py:16-22."""
    if name not in BATCHMINING_METHODS:
        raise NotImplementedError(f"Batchmining {name} is not ported yet (distance only)")
    return BATCHMINING_METHODS[name].BatchMiner(opt)
