"""Loss registry (port of vit_reranking_tpu/losses/__init__.py, reference
criteria/__init__.py:16-62) for the margin loss; the other losses come with
later slices.

``select(loss, opt, batchminer)`` returns the criterion, an ``nn.Module``
whose parameters the training engine trains at the criterion's ``lr``
(cli/common.py::build_labels).
"""

from __future__ import annotations

from .margin import MarginLoss

LOSSES = {"margin": MarginLoss}


def select(loss: str, opt, batchminer=None):
    if loss not in LOSSES:
        raise NotImplementedError(f"Loss {loss} is not ported yet (margin only)")
    cls = LOSSES[loss]
    if cls.REQUIRES_BATCHMINER:
        if batchminer is None:
            raise ValueError(
                f"Loss {loss} requires one of the following batch mining methods: "
                f"{cls.ALLOWED_MINING_OPS}"
            )
        if batchminer.name not in cls.ALLOWED_MINING_OPS:
            raise ValueError(f"{batchminer.name}-mining not allowed for {loss}-loss!")
        return cls(opt, batchminer)
    return cls(opt)
