"""Step-1 global-embedding DML training (reference train_baseline.py).

Port of vit_reranking_tpu/cli/train_baseline.py for one card, in f32: the
same flags and loop shape (per-epoch training with mining and loss, eval
every ``--evalevery`` epochs: test-set embedding -> N x N cosine with
self-masking -> R@1 / RP / MAP@R, best-checkpoint copy on R@1, patience
early stop).  The model is randomly initialised from ``--seed``.  Options
the port does not have yet (bf16 and narrow-softmax training, the device
image cache, meshes, resuming, step checkpoints) raise.

    python -m vit_reranking_tpu_torch.cli.train_baseline --dataset synthetic \
        --arch cvt_13_normalize --loss margin --batch_mining distance \
        --save_path "$(mktemp -d)"
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..core.checkpoint import copy_best, save_checkpoint
from ..core.config import from_args
from ..core.logger import RunLogger
from ..data.loader import build_dataset
from ..engine.extract import extract_features
from ..engine.metrics import metrics_from_scores, summarize
from ..ops.topk import similarity_matrix
from .common import build_training, refuse_unported, run_train_step, seed_everything


def evaluate_plain(model, loader, device) -> Dict[str, float]:
    """In-train eval (train_baseline.py:247-326): embed, N x N cosine with
    the diagonal masked, metrics in percent."""
    feats = extract_features(model, loader, grid_size=1, device=device)
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


def main(argv=None) -> Dict[str, object]:
    """Train; returns ``{"best_r1", "step_loss", "step_seconds", "eval",
    "run_dir"}``: every step's loss and seconds (from the batch's copy to the
    card to the end of the optimizer update) and each evaluation's metrics.
    Losses stay on the device until the epoch ends, as in the JAX package:
    no step waits for the host."""
    opt = from_args(argv)
    refuse_unported(opt, "trains")
    device = torch.device(opt.device)
    # f32 products and convolutions in full f32, as the JAX package pins
    # Precision.HIGHEST on its parity-critical contractions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed_everything(opt.seed, debug=opt.debug)

    loaders, _ = build_dataset(opt)
    train_loader = loaders["training"]
    steps_per_epoch = len(train_loader)
    model, criterion, state = build_training(opt, steps_per_epoch, device)
    logger = RunLogger(opt)
    print(f"[train_baseline] run dir: {logger.run_dir}")

    # the miner's draws (the JAX package's PRNGKey(seed + 1) stream)
    generator = torch.Generator(device=device).manual_seed(opt.seed + 1)
    summary = {"best_r1": -1.0, "step_loss": [], "step_seconds": [], "eval": [],
               "run_dir": logger.run_dir}
    best_r1, patience_ctr = -1.0, 0
    clock = _StepClock(device)
    for epoch in range(opt.start_epoch, opt.n_epochs):
        t0 = time.time()
        epoch_losses = []
        for lab, images, _ in train_loader:
            begun = clock.start()
            m = run_train_step(state, lab, images, generator, device)
            clock.stop(begun)
            epoch_losses.append(m["loss"])
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

        if epoch % opt.evalevery == 0 or epoch == opt.n_epochs - 1:
            te = time.time()
            metrics = evaluate_plain(model, loaders["testing"], device)
            _sync(device)
            summary["eval"].append(metrics)
            logger.log("Test", metrics, epoch)
            print(f"  eval ({time.time() - te:.1f}s): {metrics}")
            ckpt = {
                "params": model.state_dict(),
                "loss_params": criterion.state_dict(),
                "opt_state": state.optimizer.state_dict(),
                "step": state.step,
                "epoch": epoch,
            }
            save_checkpoint(f"{logger.run_dir}/latest", ckpt, metrics)
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


if __name__ == "__main__":
    main()
