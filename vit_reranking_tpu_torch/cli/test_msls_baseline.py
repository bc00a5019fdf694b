"""MSLS recall evaluation (reference test_msls_baseline.py): a model from
``--resume_path`` (a trainer checkpoint) or ``--pretrained_ckpt``, then
global Recall@N and, with ``--use_ot``, the DIML rerank of each query's top
100 (the query != gallery featvit rerank, kernel K1 on the card).

Port of vit_reranking_tpu/cli/test_msls_baseline.py: the same split
(``val``; the synthetic stand-in's ``train``), batch 8 and printed lines.

    python -m vit_reranking_tpu_torch.cli.test_msls_baseline --dataset msls \
        --source_path MSLS_ROOT --arch cvt_13_normalize --embed_dim 128 \
        --imageresizeh 224 --imageresizew 224 --use_ot --resume_path RUN/best
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.checkpoint import load_checkpoint
from ..core.config import from_args
from ..engine.msls_val import msls_val
from .common import seed_everything
from .train_msls_baseline import build_model, build_msls, make_extract_fn, refuse_msls_unported


def main(argv=None) -> Dict[str, float]:
    """Evaluate; returns msls_val's recalls."""
    opt = from_args(argv)
    refuse_msls_unported(opt)
    device = torch.device(opt.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed_everything(opt.seed)
    eval_set = build_msls(opt, "val" if opt.dataset != "synthetic" else "train")
    model = build_model(opt, device)
    if opt.resume_path:
        model.load_state_dict(load_checkpoint(opt.resume_path, map_location=device)["params"])
    extract = make_extract_fn(model, opt.use_ot, device, grid_size=opt.grid_size)
    recalls = msls_val(eval_set, extract, trunc_nums=(0, 100) if opt.use_ot else (0,), batch=8)
    for k, v in recalls.items():
        print(f"====> {k.replace('globalR_', 'Recall@').replace('dimlR_', 'DIML Recall@')}: "
              f"{v:.4f}")
    return recalls


if __name__ == "__main__":
    main()
