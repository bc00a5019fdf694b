"""MSLS place-recognition training with triplets (reference
train_msls_baseline.py + training_tools/train_epoch.py).

Port of vit_reranking_tpu/cli/train_msls_baseline.py for one card, the
baseline path.  Per epoch: weighted query subcaches, then for each subcache
hard-negative mining with the current model (its embeddings on the card,
the ranking in numpy on the host, data/msls.py), the triplets shuffled with
numpy's global generator, and triplet steps of ``--bs`` triplets (4 on
``--dataset synthetic``): query, positive and ``--nNeg`` negatives through
one forward in training mode, frames aggregated, the triplet loss times
``--tl_weight``.  Adam, or SGD with momentum, with the coupled weight decay
``--weightdecay`` and the step schedule ``lr * lrgamma ** ((step // 1000)
// lrstep)``.  Every ``--evalevery`` epochs: global Recall@N on the
validation split (engine/msls_val.py), ``latest`` saved and copied to
``best`` on a better ``globalR_5``.  ``--checkpoint_every_steps`` saves at
every subcache boundary, and ``--resume_path`` resumes there with the same
later pools and triplets (cli/common.py).

The precision is the JAX CLI's: f32 unless ``--bf16`` is given, on the card
too (the JAX trainer never resolves it).  Distillation (``--distill``),
``--enable_xbm``, ``--task_loss supcon``, ``--track_drift``,
``--cache_device`` and ``--mesh_shape`` raise ``NotImplementedError``.

    python -m vit_reranking_tpu_torch.cli.train_msls_baseline --dataset msls \
        --source_path MSLS_ROOT --arch cvt_13_normalize --embed_dim 128 --nNeg 5 \
        --margin 0.1 --lr 0.0001 --optim adam --lrstep 20 --lrgamma 0.5 \
        --n_epochs 30 --evalevery 1 --cachebatchsize 20 --imageresizeh 224 \
        --imageresizew 224 --save_path "$(mktemp -d)"
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import models as archs
from ..core.checkpoint import copy_best, save_checkpoint
from ..core.config import Config, from_args
from ..core.logger import RunLogger
from ..data.msls import MSLS, SyntheticMSLS
from ..data.transforms import input_transform
from ..engine.extract import embed_batch
from ..engine.msls_val import msls_val
from ..engine.train import make_optimizer
from ..losses.msls import msls_triplet_loss
from ..utils.visual import visual_msls_triptych
from .common import (_to_device, load_pretrained_into, maybe_msls_subcache_checkpoint,
                     refuse_unported, resume_msls_state, seed_everything)
from .train_baseline import _StepClock


def refuse_msls_unported(opt: Config) -> None:
    """Raise ``NotImplementedError`` naming the first option of ``opt`` that
    the MSLS CLIs' port lacks: distillation, the cross-batch memory, the
    supervised-contrastive task loss, feature-drift tracking, the device
    pools of the subcaches (``MSLSSubcachePool``) and meshes."""
    refuse_unported(opt)
    for flag, on in (("distill", opt.distill), ("enable_xbm", opt.enable_xbm),
                     ("task_loss supcon", opt.task_loss == "supcon"),
                     ("track_drift", opt.track_drift), ("cache_device", opt.cache_device)):
        if on:
            raise NotImplementedError(f"--{flag} is not ported to the MSLS CLIs yet")


def build_msls(opt: Config, mode: str):
    """The MSLS split ``mode``: the synthetic stand-in (48 queries, 96
    database images of ``--msls_image_size`` px), or the city tree under
    ``--source_path`` (every city of the mode, or ``amman`` with
    ``--mini_data``) resized to ``--imageresizeh`` x ``--imageresizew``."""
    if opt.dataset == "synthetic":
        return SyntheticMSLS(
            n_queries=48, n_db=96, nNeg=opt.nNeg, image_size=opt.msls_image_size,
            cached_queries=16, cached_negatives=48, margin=opt.margin,
            seed=opt.seed, mode=mode, task=opt.msls_task, seq_length=opt.msls_seq_length,
        )
    return MSLS(
        opt.source_path,
        cities="" if not opt.mini_data else "amman",
        nNeg=opt.nNeg,
        transform=input_transform((opt.imageresizeh, opt.imageresizew)),
        mode=mode,
        task=opt.msls_task, subtask=opt.msls_subtask,
        seq_length=opt.msls_seq_length,
        cached_queries=1000, cached_negatives=1000,
        bs=opt.cachebatchsize, margin=opt.margin, seed=opt.seed,
    )


def input_side(opt: Config) -> int:
    """The input's height in pixels (the ViT's position embedding)."""
    return opt.msls_image_size if opt.dataset == "synthetic" else opt.imageresizeh


def build_model(opt: Config, device: torch.device) -> torch.nn.Module:
    """``opt.arch`` randomly initialised from ``--seed``, then
    ``--pretrained_ckpt`` converted into it, on ``device``."""
    model = archs.select(opt.arch, opt, generator=torch.Generator().manual_seed(opt.seed),
                         img_size=input_side(opt))
    return load_pretrained_into(opt, model).to(device)


def _images(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """NHWC host images -> NCHW on ``device``."""
    return _to_device(a, device).permute(0, 3, 1, 2).contiguous()


def make_extract_fn(model, with_dense: bool, device: torch.device, grid_size: int = 7):
    """msls_val's ``extract_fn``: a batch of host images through ``model``
    in evaluation mode on ``device`` -> (global embeddings, the patch bank
    pooled to ``grid_size`` or None).  The bank is built either way, as the
    JAX package builds it (a non-square input raises ``ValueError``)."""

    def fn(images):
        model.eval()
        res = embed_batch(model, _images(images, device), grid_size)
        return res["center"], (res["bank"] if with_dense else None)

    return fn


def make_mining_embed(model, device: torch.device):
    """Subcache mining's ``embed_fn``: host images -> the model's global
    embeddings in evaluation mode, back on the host as f32 numpy."""

    @torch.no_grad()
    def fn(images):
        model.eval()
        return model(_images(images, device))[0].float().cpu().numpy()

    return fn


def _frames(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) with any leading dims -> (frames, H, W, 3)."""
    return x.reshape(-1, *x.shape[-3:])


def _agg_frames(e: torch.Tensor, L: int) -> torch.Tensor:
    """(B*L, D) frame embeddings -> (B, D) L2-normalised means; single
    frames pass through."""
    if L == 1:
        return e
    e = e.reshape(-1, L, e.shape[-1]).mean(1)
    return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-12)


def lr_at(opt: Config, count: int) -> float:
    """The learning rate of step ``count``: optax's staircase
    ``exponential_decay(lr, lrstep, lrgamma)`` at ``count // 1000``
    (vit_reranking_tpu/cli/train_msls_baseline.py:174-188)."""
    return opt.lr * opt.lrgamma ** ((count // 1000) // opt.lrstep)


def make_msls_optimizer(opt: Config, model: torch.nn.Module) -> torch.optim.Optimizer:
    """Adam or SGD with momentum over every parameter of ``model``, the
    weight decay added to the gradient first (optax's
    ``add_decayed_weights`` ahead of ``scale_by_adam`` / ``trace``)."""
    return make_optimizer(opt.optim, opt.weightdecay, {"model": list(model.parameters())},
                          {"model": opt.lr}, momentum=opt.momentum)


def msls_train_step(opt: Config, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    count: int, q: torch.Tensor, p: torch.Tensor,
                    negs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One triplet step (NHWC images on the model's device): q (B, [L,] H,
    W, 3), p likewise, negs (B, nNeg, [L,] H, W, 3) through one forward in
    training mode, frames aggregated to sequence descriptors, the triplet
    loss times ``--tl_weight``, backward and the update at
    :func:`lr_at` ``(count)``.  A parameter the loss does not reach gets a
    zero gradient, as under ``jax.grad``.  Returns the loss before the
    update and the gradients' L2 norm, as device scalars."""
    model.train()
    nq = q.shape[0]
    Lq = q.shape[1] if q.ndim == 5 else 1
    Ldb = p.shape[1] if p.ndim == 5 else 1
    images = torch.cat([_frames(q), _frames(p), _frames(negs)])
    emb = model(images.permute(0, 3, 1, 2).contiguous())[0]
    eq = _agg_frames(emb[: nq * Lq], Lq)
    ep = _agg_frames(emb[nq * Lq : nq * (Lq + Ldb)], Ldb)
    en = _agg_frames(emb[nq * (Lq + Ldb) :], Ldb).reshape(nq, -1, emb.shape[-1])
    loss = opt.tl_weight * msls_triplet_loss(eq, ep, en, margin=opt.margin)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    lr = lr_at(opt, count)
    for group in optimizer.param_groups:
        for prm in group["params"]:
            if prm.grad is None:
                prm.grad = torch.zeros_like(prm)
        group["lr"] = lr
    with torch.no_grad():
        grads = [prm.grad for prm in model.parameters()]
        grad_l2 = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads, 2)))
    optimizer.step()
    return {"loss": loss.detach(), "grad_l2": grad_l2}


def batch_arrays(train_set, batch_ids):
    """The triplets ``batch_ids`` loaded: (q, p, negs) stacked host arrays."""
    items = [train_set[i] for i in batch_ids]
    return tuple(np.stack([it[k] for it in items]) for k in range(3))


def main(argv=None) -> Dict[str, object]:
    """Train; returns ``{"best_r5", "step_loss", "step_seconds",
    "mine_seconds", "triplets", "eval", "run_dir", "resumed", "model"}``:
    every step's loss and seconds (CUDA events on the card), every
    subcache's mining seconds and triplets (``(epoch, subcache,
    triplets)``), each validation's recalls, the ``(epoch, subcache, step)``
    a resumed run restored (else None) and the trained model."""
    opt = from_args(argv)
    refuse_msls_unported(opt)
    device = torch.device(opt.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print("[train_msls] precision: " + ("bf16 activations, f32 parameters" if opt.bf16
                                         else "f32"))
    seed_everything(opt.seed, debug=opt.debug)

    train_set = build_msls(opt, "train")
    val_set = build_msls(opt, "val" if opt.dataset != "synthetic" else "train")
    model = build_model(opt, device)
    optimizer = make_msls_optimizer(opt, model)
    logger = RunLogger(opt)
    print(f"[train_msls] run dir: {logger.run_dir}")
    B = opt.bs if opt.dataset != "synthetic" else 4

    summary = {"best_r5": -1.0, "step_loss": [], "step_seconds": [], "mine_seconds": [],
               "triplets": [], "eval": [], "run_dir": logger.run_dir, "resumed": None,
               "model": model}
    best_r5, it_count = -1.0, 0
    start_epoch, resume_epoch, resume_sub, mining_restored = opt.start_epoch, None, 0, None
    if opt.resume_path:
        it_count, resume_epoch, resume_sub, mining_restored = resume_msls_state(
            opt.resume_path, model, optimizer)
        start_epoch = resume_epoch
        summary["resumed"] = (resume_epoch, resume_sub, it_count)
        print(f"[train_msls] resumed {opt.resume_path} (epoch {resume_epoch}, subcache "
              f"{resume_sub}, it {it_count}, mining={'yes' if mining_restored else 'no'})")

    clock = _StepClock(device)
    mine_embed = make_mining_embed(model, device)
    for epoch in range(start_epoch, opt.n_epochs):
        if mining_restored is not None and epoch == resume_epoch:
            train_set.set_mining_state(mining_restored)
            start_sub, mining_restored = resume_sub, None
        else:
            train_set.new_epoch()
            start_sub = 0
        epoch_losses = []
        t0 = time.time()
        for sub in range(start_sub, train_set.nCacheSubset):
            tm = time.perf_counter()
            train_set.update_subcache(mine_embed, opt.embed_dim)
            summary["mine_seconds"].append(time.perf_counter() - tm)
            summary["triplets"].append(
                (epoch, sub, [tuple(int(i) for i in t) for t, _ in train_set.triplets]))
            trips = list(range(len(train_set)))
            np.random.shuffle(trips)
            for step_i, s in enumerate(range(0, len(trips) - B + 1, B)):
                q, p, negs = batch_arrays(train_set, trips[s : s + B])
                if sub == 0 and step_i < 3:
                    # the input triptych of the first steps of every epoch
                    # (reference train_epoch.py:106-123); sequences show
                    # their center frame
                    center = lambda a: a[a.shape[0] // 2] if a.ndim == 4 else a
                    visual_msls_triptych(center(q[0]), center(p[0]), center(negs[0][0]),
                                         save_path=f"{logger.run_dir}/visual/{epoch}_{step_i}.png")
                begun = clock.start()
                m = msls_train_step(opt, model, optimizer, it_count, _to_device(q, device),
                                    _to_device(p, device), _to_device(negs, device))
                clock.stop(begun)
                epoch_losses.append(m["loss"])
                it_count += 1
            # the subcache boundary: the one point where the model and the
            # mining state agree
            maybe_msls_subcache_checkpoint(opt, logger.run_dir, model, optimizer, it_count,
                                           epoch, train_set)
        secs = clock.drain()
        losses = [float(x) for x in epoch_losses]
        summary["step_loss"].extend(losses)
        summary["step_seconds"].extend(secs)
        if losses:
            print(f"epoch {epoch}: loss={np.mean(losses):.4f} ({len(losses)} steps, "
                  f"{time.time() - t0:.1f}s)")
            logger.log("Train", {"loss": float(np.mean(losses))}, epoch)
        else:
            print(f"epoch {epoch}: resumed past its final subcache (0 steps)")

        if epoch % opt.evalevery == 0 or epoch == opt.n_epochs - 1:
            recalls = msls_val(val_set, make_extract_fn(model, False, device),
                               trunc_nums=(0,), batch=8)
            summary["eval"].append(recalls)
            logger.log("Test", recalls, epoch)
            print("  val: " + ", ".join(f"{k}={v:.3f}" for k, v in recalls.items()))
            if not maybe_msls_subcache_checkpoint(opt, logger.run_dir, model, optimizer,
                                                  it_count, epoch, train_set, metrics=recalls):
                save_checkpoint(f"{logger.run_dir}/latest", {"params": model.state_dict()},
                                recalls)
            r5 = recalls.get("globalR_5", 0.0)
            if r5 > best_r5:
                best_r5 = r5
                copy_best(logger.run_dir)
    logger.plot_curves()
    print(f"best R@5: {best_r5:.4f}")
    summary["best_r5"] = best_r5
    return summary


if __name__ == "__main__":
    main()
