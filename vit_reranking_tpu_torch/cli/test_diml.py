"""DIML rerank evaluation — the engine behind the test_diml_* entry points.

Port of vit_reranking_tpu/cli/test_diml.py::run_eval/main (reference
test_diml_cvt.py, test_diml_vit.py) for the rollout, qk and featvit
methods: embed the test split (with attention-rollout extraction for
``--use_rollout``, with the probed block's q/k for ``--use_qk``), run
stage-0 retrieval + the Sinkhorn OT rerank for every requested truncation,
print the metric table and append a row to
``test_results/test_diml_{dataset}.csv`` relative to the working directory
(reference test_diml_cvt.py:155-161).  Without ``--use_rollout`` or
``--use_qk`` the method is featvit (cross-attention marginals).

The model is randomly initialised from a ``torch.Generator`` seeded with
``--seed``; checkpoint and pretrained loading, feature caching and the
``--sweep`` over trained runs come with later slices, and the options that
need them (``--resume_path``, ``--bf16``, ``--narrow_sm``,
``--cache_device``, ``--mesh_shape``, ``--checkpoint_every_steps``) raise.
Tensors live on ``--device`` (``cuda`` unless told otherwise).

    python -m vit_reranking_tpu_torch.cli.test_diml_cvt --dataset synthetic \
        --arch cvt_13_normalize --use_rollout --use_ot --bs 32
    python -m vit_reranking_tpu_torch.cli.test_diml_vit --dataset synthetic \
        --arch vit_normalize --use_qk --blk_ind 0 --use_ot --grid_size 14 --bs 16
"""

from __future__ import annotations

import csv
import os
import time

import torch

from .. import models as archs
from ..core.config import Config, from_args
from ..data.loader import build_eval_loaders
from ..engine.extract import extract_features
from ..engine.rerank_eval import rerank_evaluate
from .common import refuse_unported


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_eval(opt: Config, trunc_nums=(0, 100)):
    refuse_unported(opt, "evaluates")
    device = torch.device(opt.device)
    # f32 products and convolutions in full f32, as the JAX package pins
    # Precision.HIGHEST on its parity-critical contractions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    test_loader = build_eval_loaders(opt)["testing"]
    # the model is sized from the first batch, as the JAX package inits it
    batches = iter(test_loader)
    _, images0, _ = next(batches)
    batches.close()
    gen = torch.Generator().manual_seed(opt.seed)
    model = archs.select(opt.arch, opt, generator=gen, img_size=images0.shape[1])
    model = model.to(device).eval()

    # JAX cli/test_diml.py:148-154 (the port has no --use_cam, --use_mh or
    # --use_dist yet)
    method = "rollout" if opt.use_rollout else "qk" if opt.use_qk else "featvit"
    t0 = time.perf_counter()
    feats = extract_features(
        model, test_loader, grid_size=opt.grid_size, use_rollout=method == "rollout",
        device=opt.device, use_qk=method == "qk",
    )
    _sync(device)
    t_extract = time.perf_counter() - t0
    n = len(feats["labels"])
    print(f"embedded {n} images in {t_extract:.3f}s")

    flags = dict(
        use_uniform=opt.use_uniform,
        use_inverse=opt.use_inverse,
        temperature=opt.temperature,
        use_cls_token=opt.use_cls_token,
        use_minus=opt.use_minus,
        use_soft=opt.use_soft,
        ot_part=opt.ot_part,
        use_ot=opt.use_ot,
        # reference scale: ViT q.k / 8 (diml.py:235), CvT unscaled (diml.py:292)
        qk_scale=1.0 if opt.arch.startswith("cvt") else 1.0 / 8.0,
    )
    # the q/k banks ride the rollout slots for the qk method
    if method == "qk":
        aux, aux_g = feats["q"], feats["k"]
    else:
        aux, aux_g = feats.get("rollout"), None
    trunc_nums = tuple(t for t in trunc_nums if t == 0 or t < n)
    t0 = time.perf_counter()
    results = rerank_evaluate(
        feats["bank"], feats["center"], feats["labels"], rollout=aux, rollout_g=aux_g,
        trunc_nums=trunc_nums,
        method=method,
        flags=flags,
        approx_topk=opt.approx_topk,
        stream_dtype="bfloat16" if opt.rerank_bf16 else "float32",
    )
    _sync(device)
    dt = time.perf_counter() - t0
    n_pairs = n * max(trunc_nums)
    print(f"rerank eval in {dt:.3f}s ({n_pairs / max(dt, 1e-9):,.0f} pairs/s)")

    for trunc in trunc_nums:
        print(f"trunc_num: {trunc}, ot part: {opt.ot_part}")
        print("###########")
        print(
            "Now rank-1 acc=%f, RP=%f, MAP@R=%f"
            % (results["r1"][trunc], results["rp"][trunc], results["mapr"][trunc])
        )

    os.makedirs("test_results", exist_ok=True)
    out_csv = f"test_results/test_diml_{opt.dataset}.csv"
    write_header = not os.path.exists(out_csv)
    with open(out_csv, "a", newline="") as f:
        w = csv.writer(f)
        if write_header:
            w.writerow(
                ["arch", "grid", "ot_part", "method"]
                + [f"{m}@{t}" for m in ("r1", "rp", "mapr") for t in trunc_nums]
            )
        w.writerow(
            [opt.arch, opt.grid_size, opt.ot_part, method]
            + [round(results[m][t], 4) for m in ("r1", "rp", "mapr") for t in trunc_nums]
        )
    return results


def main(argv=None):
    return run_eval(from_args(argv), trunc_nums=(0, 100))


if __name__ == "__main__":
    main()
