"""DIML rerank evaluation — the engine behind the test_diml_* entry points.

Port of vit_reranking_tpu/cli/test_diml.py::run_eval/main (reference
test_diml_cvt.py) for the rollout method: embed the test split with
attention-rollout extraction, run stage-0 retrieval + the Sinkhorn OT rerank
for every requested truncation, print the metric table and append a row to
``test_results/test_diml_{dataset}.csv`` relative to the working directory
(reference test_diml_cvt.py:155-161).

The model is randomly initialised from a ``torch.Generator`` seeded with
``--seed``; checkpoint and pretrained loading, feature caching and the
``--sweep`` over trained runs come with later slices.  Tensors live on
``--device`` (``cuda`` unless told otherwise).

    python -m vit_reranking_tpu_torch.cli.test_diml_cvt --dataset synthetic \
        --arch cvt_13_normalize --use_rollout --use_ot --bs 32
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_eval(opt: Config, trunc_nums=(0, 100)):
    if not opt.use_rollout:
        raise NotImplementedError(
            "only the --use_rollout rerank is ported yet (featvit/qk/cam/mhvit/dist wait)"
        )
    device = torch.device(opt.device)
    # f32 products and convolutions in full f32, as the JAX package pins
    # Precision.HIGHEST on its parity-critical contractions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    test_loader = build_eval_loaders(opt)["testing"]
    gen = torch.Generator().manual_seed(opt.seed)
    model = archs.select(opt.arch, opt, generator=gen).to(device).eval()

    t0 = time.perf_counter()
    feats = extract_features(
        model, test_loader, grid_size=opt.grid_size, use_rollout=True, device=opt.device
    )
    _sync(device)
    t_extract = time.perf_counter() - t0
    n = len(feats["labels"])
    print(f"embedded {n} images in {t_extract:.3f}s")

    flags = dict(use_uniform=opt.use_uniform, ot_part=opt.ot_part, use_ot=opt.use_ot)
    trunc_nums = tuple(t for t in trunc_nums if t == 0 or t < n)
    t0 = time.perf_counter()
    results = rerank_evaluate(
        feats["bank"], feats["center"], feats["labels"], rollout=feats["rollout"],
        trunc_nums=trunc_nums,
        method="rollout",
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
            [opt.arch, opt.grid_size, opt.ot_part, "rollout"]
            + [round(results[m][t], 4) for m in ("r1", "rp", "mapr") for t in trunc_nums]
        )
    return results


def main(argv=None):
    return run_eval(from_args(argv), trunc_nums=(0, 100))


if __name__ == "__main__":
    main()
