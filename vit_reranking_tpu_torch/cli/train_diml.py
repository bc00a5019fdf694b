"""Structural (OT) loss training with the rerank evaluation (reference
train_diml.py).

Port of vit_reranking_tpu/cli/train_diml.py for one card: train_baseline's
loop (cli/train_baseline.py::train: pools, resume, step checkpoints,
`latest` / `best`, patience) on a DIML model (``resnet50_diml*``, or a
``cvt*`` arch, rewritten to ``cvt_diml*`` as the JAX CLI does) with a
structural loss (``margin_diml``), the cls embedding handed to the loss as
``class_token`` under ``--use_cls_token``, and an in-train evaluation that
embeds the test split in training mode (the per-patch map is the bank) and
reranks each query's top 100 with the featvit method (kernel K1 on the
card; train_diml.py:297-402).  The precision default is this CLI's own
(core/config.py::resolve_diml_precision): bf16 on the card for every
``cvt*`` arch, CvT-DIML included, and ``resnet50*``.  Storage-based samplers
and ``--mesh_shape`` raise.

    python -m vit_reranking_tpu_torch.cli.train_diml --dataset cub200 \
        --source_path data --arch resnet50_diml_frozen_normalize \
        --loss margin_diml --batch_mining distance --save_path "$(mktemp -d)"
"""

from __future__ import annotations

import functools
from typing import Dict

from ..core.config import Config, from_args, resolve_diml_precision
from ..engine.extract import embed_split
from ..engine.rerank_eval import rerank_evaluate
from .train_baseline import train


def evaluate_rerank(opt: Config, model, loader, device, eval_cache=None,
                    trunc: int = 100) -> Dict[str, float]:
    """In-train evaluation (train_diml.py:297-402): the test split embedded
    in training mode (from the resident pool under ``--cache_device``), the
    featvit rerank of each query's top ``trunc`` (only the global ranking
    when the split has ``trunc`` images or fewer); R@1 / RP / MAP@R of the
    last truncation and the global R@1, in percent."""
    feats = embed_split(model, loader, eval_cache, grid_size=opt.grid_size, device=device,
                        training_mode=True)
    n = len(feats["labels"])
    truncs = (0, trunc) if trunc < n else (0,)
    res = rerank_evaluate(
        feats["bank"], feats["center"], feats["labels"], trunc_nums=truncs, method="featvit",
        flags=dict(use_uniform=opt.use_uniform, use_inverse=opt.use_inverse,
                   temperature=opt.temperature, use_cls_token=opt.use_cls_token,
                   use_minus=opt.use_minus, ot_part=opt.ot_part),
    )
    t = truncs[-1]
    return {"r1": res["r1"][t], "rp": res["rp"][t], "mapr": res["mapr"][t],
            "r1_global": res["r1"][0]}


def main(argv=None) -> Dict[str, object]:
    """Train; returns cli/train_baseline.py::train's summary."""
    opt = from_args(argv)
    if "diml" not in opt.arch and opt.arch.startswith("cvt"):
        opt = opt.replace(arch=opt.arch.replace("cvt", "cvt_diml", 1))
    opt = resolve_diml_precision(opt)
    return train(opt, "train_diml", functools.partial(evaluate_rerank, opt))


if __name__ == "__main__":
    main()
