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
``--seed``, then ``--pretrained_ckpt`` (a torch checkpoint of the
reference's backbone) is converted into it, and ``--resume_path`` (a run's
``best`` or ``latest`` directory) replaces its weights with the trained
ones.  ``--sweep RUNS_ROOT`` evaluates every run under a root and writes
one row a run to ``test_results/sweep_{dataset}.csv``.  ``--bf16`` builds
the model with bf16 activations and ``--narrow_sm`` narrows its softmax, as
given (both off unless set: the evaluation resolves no default, as the JAX
evaluation); ``--cache_device`` loads the test split once into the card's
memory and embeds it there (vit_reranking_tpu/cli/test_diml.py:116-131).
``--training`` evaluates a DIML model: its per-patch output is the bank
and its ``enc_out`` the center (test_diml.py:127, :138).
Feature caching (``--cache_path``) waits for a later slice, and
``--mesh_shape`` raises.  Tensors live on ``--device`` (``cuda`` unless
told otherwise).

    python -m vit_reranking_tpu_torch.cli.test_diml_cvt --dataset cub200 \
        --source_path data --arch cvt_13_normalize --resume_path RUN/best \
        --use_cls_token --use_inverse --use_rollout --use_ot --bs 16
    python -m vit_reranking_tpu_torch.cli.test_diml_vit --dataset synthetic \
        --arch vit_normalize --use_qk --blk_ind 0 --use_ot --grid_size 14 --bs 16
"""

from __future__ import annotations

import csv
import os
import sys
import time

import torch

from .. import models as archs
from ..core.checkpoint import load_checkpoint
from ..core.config import Config, from_args
from ..data.device_cache import DeviceEvalCache
from ..data.loader import build_eval_loaders
from ..engine.extract import embed_split
from ..engine.rerank_eval import rerank_evaluate
from .common import load_pretrained_into, refuse_unported, setup_pool


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_eval(opt: Config, trunc_nums=(0, 100)):
    """Evaluate ``opt``'s model at each truncation of ``trunc_nums`` below
    the test split's size; returns ``{"r1", "rp", "mapr"}``, each truncation
    -> percent."""
    refuse_unported(opt)
    device = torch.device(opt.device)
    # f32 products and convolutions in full f32, as the JAX package pins
    # Precision.HIGHEST on its parity-critical contractions; bf16 products
    # accumulate in f32, as the JAX package's do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    test_loader = build_eval_loaders(opt)["testing"]
    # the model is sized from the first batch, as the JAX package inits it
    batches = iter(test_loader)
    _, images0, _ = next(batches)
    batches.close()
    gen = torch.Generator().manual_seed(opt.seed)
    model = archs.select(opt.arch, opt, generator=gen, img_size=images0.shape[1])
    model = load_pretrained_into(opt, model)
    if opt.resume_path:
        model.load_state_dict(load_checkpoint(opt.resume_path)["params"])
    model = model.to(device).eval()

    # JAX cli/test_diml.py:148-154 (the port has no --use_cam, --use_mh or
    # --use_dist yet)
    method = "rollout" if opt.use_rollout else "qk" if opt.use_qk else "featvit"
    t0 = time.perf_counter()
    pool = setup_pool(opt, DeviceEvalCache, test_loader.dataset, device, "test_diml")
    feats = embed_split(model, test_loader, pool, grid_size=opt.grid_size,
                        use_rollout=method == "rollout", use_qk=method == "qk",
                        device=opt.device, training_mode=opt.training)
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


def sweep(opt: Config, runs_root: str, trunc_nums=(0, 100)):
    """Evaluate every trained run under ``runs_root`` (its ``best``
    checkpoint, else its ``latest``; the reference's sweep tables,
    test_diml.py:100-183) and write one row a run to
    ``test_results/sweep_{dataset}.csv``.  Returns ``[(run, results)]``."""
    rows = []
    for name in sorted(os.listdir(runs_root)):
        for which in ("best", "latest"):
            ckpt = os.path.join(runs_root, name, which)
            if os.path.isdir(ckpt):
                break
        else:
            continue
        print(f"=== {name} ===")
        rows.append((name, run_eval(opt.replace(resume_path=ckpt, group=name), trunc_nums)))
    # the truncations run_eval kept (those below the test split's size)
    truncs = tuple(rows[0][1]["r1"]) if rows else trunc_nums
    os.makedirs("test_results", exist_ok=True)
    out_csv = f"test_results/sweep_{opt.dataset}.csv"
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["run"] + [f"{m}@{t}" for m in ("r1", "rp", "mapr") for t in truncs])
        for name, res in rows:
            w.writerow([name] + [round(res[m][t], 4)
                                 for m in ("r1", "rp", "mapr") for t in truncs])
    print(f"sweep table written to {out_csv}")
    return rows


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``); ``--sweep RUNS_ROOT``
    evaluates every run under the root, otherwise one evaluation."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--sweep" in argv:
        i = argv.index("--sweep")
        runs_root = argv[i + 1]
        return sweep(from_args(argv[:i] + argv[i + 2:]), runs_root, trunc_nums=(0, 100))
    return run_eval(from_args(argv), trunc_nums=(0, 100))


if __name__ == "__main__":
    main()
