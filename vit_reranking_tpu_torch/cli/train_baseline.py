"""Step-1 global-embedding DML training (reference train_baseline.py).

Port of vit_reranking_tpu/cli/train_baseline.py for one card: the same
flags and loop shape (per-epoch training with mining and loss, eval every
``--evalevery`` epochs: test-set embedding -> N x N cosine with
self-masking -> R@1 / RP / MAP@R, best-checkpoint copy on R@1, patience
early stop; :func:`train`, which cli/train_diml.py shares).  The model is
randomly initialised from ``--seed``, then
``--pretrained_ckpt`` (the reference's torch checkpoint of the backbone) is
converted into it.  ``--resume_path`` restores a run's checkpoint (model,
loss, optimizer and step count; the loop still starts at
``--start_epoch``); ``--save_every_epoch`` and ``--checkpoint_every_steps``
refresh ``latest`` between evaluations.  The precision is the JAX package's
default: on the card, CvT and Swin train with bf16 activations and the
narrowed softmax (f32 parameters, BatchNorm statistics, Adam state,
LayerNorms and head); ``--no-bf16`` trains in f32, as every run on the CPU
does (``core/config.py::resolve_precision``).  ``--cache_device`` loads the
training and test splits once into the card's memory: each step gathers and
augments its batch there, each evaluation embeds from the pool
(data/device_cache.py).  Meshes (``--mesh_shape``) raise.

    python -m vit_reranking_tpu_torch.cli.train_baseline --dataset cub200 \
        --source_path data --arch cvt_13_normalize --loss margin \
        --batch_mining distance --pretrained_ckpt CvT-13-224x224-IN-1k.pth \
        --save_path "$(mktemp -d)"
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from ..core.checkpoint import copy_best, save_checkpoint
from ..core.config import from_args, resolve_precision
from ..core.logger import RunLogger
from ..data.device_cache import DeviceEvalCache, DeviceImageCache
from ..data.loader import build_dataset
from ..engine.extract import embed_split
from ..engine.metrics import metrics_from_scores, summarize
from ..ops.topk import similarity_matrix
from .common import (build_training, epoch_batches, maybe_step_checkpoint, refuse_unported,
                     resume_train_state, run_train_step, seed_everything, setup_pool,
                     train_checkpoint)


def evaluate_plain(model, loader, device, eval_cache=None) -> Dict[str, float]:
    """In-train eval (train_baseline.py:247-326): embed, N x N cosine with
    the diagonal masked, metrics in percent.  With ``eval_cache``
    (data/device_cache.py::DeviceEvalCache) the embedding runs over the
    resident test pool in the loader's batch size."""
    feats = embed_split(model, loader, eval_cache, grid_size=1, device=device)
    centers, labels = feats["center"], feats["labels"]
    sims = similarity_matrix(centers, centers, mask_self=True)
    return summarize(metrics_from_scores(sims, labels, labels, mask_diagonal=False))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _StepClock:
    """Step durations without a host sync per step: CUDA events recorded
    around each step on the card, read when the epoch ends; the host's
    ``perf_counter`` on the CPU, where every op runs to its end before it
    returns."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, begun) -> None:
        self.marks.append((begun, self.start()))

    def drain(self):
        """Seconds of every step since the last drain (waits for the card)."""
        if self.cuda and self.marks:
            self.marks[-1][1].synchronize()
        secs = [a.elapsed_time(b) / 1e3 if self.cuda else b - a for a, b in self.marks]
        self.marks = []
        return secs


def train(opt, tag: str, evaluate: Callable) -> Dict[str, object]:
    """The training loop both training CLIs share, on ``opt`` with its
    precision resolved: pools, model, criterion and optimizer, resume, the
    epochs with step checkpoints, and every ``--evalevery`` epochs
    ``evaluate(model, test_loader, device, eval_cache)`` (a metrics dict
    with ``r1``), the ``latest`` / ``best`` checkpoints and the patience
    stop.  Returns ``{"best_r1", "step_loss", "step_seconds", "eval",
    "run_dir", "resumed", "state"}``: every step's loss and seconds (from
    the batch's copy to the card to the end of the optimizer update), each
    evaluation's metrics, the ``(epoch, step)`` a resumed run restored (else
    None) and the final ``TrainState``.  Losses stay on the device until the
    epoch ends, as in the JAX package: no step waits for the host."""
    refuse_unported(opt)
    device = torch.device(opt.device)
    # f32 products and convolutions in full f32, as the JAX package pins
    # Precision.HIGHEST on its parity-critical contractions; bf16 products
    # accumulate in f32, as the JAX package's do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"[{tag}] precision: "
          + ("bf16 activations, f32 parameters" if opt.bf16 else "f32")
          + (", narrowed softmax" if opt.bf16 and opt.narrow_sm else ""))
    seed_everything(opt.seed, debug=opt.debug)

    loaders, _ = build_dataset(opt)
    train_loader = loaders["training"]
    steps_per_epoch = len(train_loader)
    cache = setup_pool(opt, DeviceImageCache, train_loader.dataset, device, tag)
    eval_cache = setup_pool(opt, DeviceEvalCache, loaders["testing"].dataset, device, tag)
    # the model is sized from the first test batch, as the JAX package inits it
    batches = iter(loaders["testing"])
    _, images0, _ = next(batches)
    batches.close()
    model, _, state = build_training(opt, steps_per_epoch, device, img_size=images0.shape[1])
    logger = RunLogger(opt)
    print(f"[{tag}] run dir: {logger.run_dir}")
    resumed = None
    if opt.resume_path:
        resumed = (resume_train_state(opt.resume_path, state), state.step)
        print(f"[{tag}] resumed {opt.resume_path} (epoch {resumed[0]}, step {resumed[1]})")

    # the miner's draws and the pool's augmentation (the JAX package's
    # PRNGKey(seed + 1) stream)
    generator = torch.Generator(device=device).manual_seed(opt.seed + 1)
    summary = {"best_r1": -1.0, "step_loss": [], "step_seconds": [], "eval": [],
               "run_dir": logger.run_dir, "resumed": resumed, "state": state}
    best_r1, patience_ctr, step = -1.0, 0, 0
    clock = _StepClock(device)
    for epoch in range(opt.start_epoch, opt.n_epochs):
        t0 = time.time()
        epoch_losses = []
        for lab, images, idx in epoch_batches(train_loader, cache):
            begun = clock.start()
            m = run_train_step(state, lab, images, generator, device, cache, idx)
            clock.stop(begun)
            epoch_losses.append(m["loss"])
            step += 1
            maybe_step_checkpoint(opt, logger.run_dir, state, epoch, step)
        secs = clock.drain()
        epoch_losses = [float(x) for x in epoch_losses]
        first = state.step - len(epoch_losses) + 1
        for i, (loss, dt) in enumerate(zip(epoch_losses, secs)):
            print(f"  step {first + i}: loss={loss:.6f} ({dt:.3f}s)")
        summary["step_loss"].extend(epoch_losses)
        summary["step_seconds"].extend(secs)
        logger.log(
            "Train",
            {
                "loss": float(np.mean(epoch_losses)),
                "grad_l2": float(m["grad_l2"]),
                "grad_max": float(m["grad_max"]),
                "epoch_s": time.time() - t0,
            },
            epoch,
        )
        print(f"epoch {epoch}: loss={np.mean(epoch_losses):.4f} "
              f"({time.time() - t0:.1f}s, {steps_per_epoch} steps)")

        if opt.save_every_epoch and epoch % opt.evalevery != 0:
            # keep `latest` fresh between evaluations, so a resumed run
            # loses at most one epoch
            save_checkpoint(f"{logger.run_dir}/latest", train_checkpoint(state, epoch), {})

        if epoch % opt.evalevery == 0 or epoch == opt.n_epochs - 1:
            te = time.time()
            metrics = evaluate(model, loaders["testing"], device, eval_cache)
            _sync(device)
            summary["eval"].append(metrics)
            logger.log("Test", metrics, epoch)
            print(f"  eval ({time.time() - te:.1f}s): {metrics}")
            save_checkpoint(f"{logger.run_dir}/latest", train_checkpoint(state, epoch), metrics)
            if metrics["r1"] > best_r1:
                best_r1 = metrics["r1"]
                copy_best(logger.run_dir)
                patience_ctr = 0
            else:
                patience_ctr += 1
                if patience_ctr >= opt.max_patience:
                    print("early stop: patience exceeded")
                    break
    logger.plot_curves()
    print(f"best R@1: {best_r1:.3f}")
    summary["best_r1"] = best_r1
    return summary


def main(argv=None) -> Dict[str, object]:
    """Train; returns :func:`train`'s summary."""
    return train(resolve_precision(from_args(argv)), "train_baseline", evaluate_plain)


if __name__ == "__main__":
    main()
