"""Shared CLI wiring: seeding, model/loss/miner/optimizer assembly from a
Config, and the per-batch train step.

Port of vit_reranking_tpu/cli/common.py for one card: the mesh, the
device-resident image cache, resuming and step checkpoints come later.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import losses, miners
from .. import models as archs
from ..core.config import Config
from ..engine.train import TrainState, init_train_state, make_optimizer, train_step


# JAX package options the port does not have yet: setting one raises
UNPORTED = ("cache_device", "mesh_shape", "resume_path", "checkpoint_every_steps")


def refuse_unported(opt: Config, what: str, reduced_precision: bool = False) -> None:
    """Raise ``NotImplementedError`` naming the first option of ``opt`` whose
    effect the port lacks (the device image cache, meshes, checkpoint
    loading, step checkpoints; bf16 and the narrowed softmax unless
    ``reduced_precision``, which training has and evaluation does not),
    rather than parse it and run without it.  ``what`` says what the CLI
    does in f32 ("evaluates")."""
    for flag in () if reduced_precision else ("bf16", "narrow_sm"):
        if getattr(opt, flag):
            raise NotImplementedError(
                f"--{flag} is not ported yet: the port {what} in f32")
    for flag in UNPORTED:
        if getattr(opt, flag):
            raise NotImplementedError(f"--{flag} is not ported yet")


def seed_everything(seed: int, debug: bool = False) -> None:
    """Seed numpy, ``random`` and PyTorch's global generators (the CPU's and
    every card's; DropPath draws from them).  ``debug`` turns on autograd's
    anomaly detection, which names the op that made a NaN."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    if debug:
        torch.autograd.set_detect_anomaly(True)


def build_labels(opt: Config, model: torch.nn.Module,
                 criterion: torch.nn.Module) -> Dict[str, List[torch.nn.Parameter]]:
    """Parameter groups: ``model``, ``fc`` (the head, with its own lr when
    ``--fc_lr`` > 0), ``frozen`` (lr 0) and ``criterion``."""
    trainable = archs.frozen_param_mask(opt.arch, model)
    groups: Dict[str, List[torch.nn.Parameter]] = {"model": [], "fc": [], "frozen": []}
    for name, p in model.named_parameters():
        if not trainable[name]:
            groups["frozen"].append(p)
        elif opt.fc_lr > 0 and ("head" in name or "last_linear" in name):
            groups["fc"].append(p)
        else:
            groups["model"].append(p)
    groups["criterion"] = list(criterion.parameters())
    return groups


def build_training(opt: Config, steps_per_epoch: int, device: torch.device):
    """Assemble ``(model, criterion, state)`` on ``device``: the model
    randomly initialised from a generator seeded with ``opt.seed``, the
    criterion with its miner, and an optimizer whose groups follow
    :func:`build_labels`."""
    model = archs.select(
        opt.arch, opt, generator=torch.Generator().manual_seed(opt.seed)
    ).to(device)
    miner = (
        miners.select(opt.batch_mining, opt)
        if losses.LOSSES[opt.loss].REQUIRES_BATCHMINER
        else None
    )
    criterion = losses.select(opt.loss, opt, miner)
    criterion.to(device)
    groups = build_labels(opt, model, criterion)
    group_lrs = {"model": opt.lr, "fc": opt.fc_lr, "frozen": 0.0,
                 "criterion": getattr(criterion, "lr", None) or opt.lr}
    optimizer = make_optimizer(opt.optim, opt.decay, groups, group_lrs)
    state = init_train_state(model, criterion, optimizer, opt.tau, opt.gamma, steps_per_epoch)
    return model, criterion, state


def run_train_step(state: TrainState, lab: np.ndarray, images: np.ndarray,
                   generator: Optional[torch.Generator], device: torch.device):
    """Move one host batch to ``device`` (images to NCHW) and take a step.
    On a card the batch goes through pinned memory, so the copy waits for
    nothing the card is still doing."""
    x = torch.from_numpy(np.ascontiguousarray(images))
    y = torch.from_numpy(np.asarray(lab))
    if torch.device(device).type == "cuda":
        x, y = x.pin_memory(), y.pin_memory()
    x = x.to(device, non_blocking=True).permute(0, 3, 1, 2)
    y = y.to(device, non_blocking=True).long()
    return train_step(state, x.contiguous(), y, generator)
