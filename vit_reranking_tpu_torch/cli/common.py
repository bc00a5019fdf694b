"""Shared CLI wiring: seeding, model/loss/miner/optimizer assembly from a
Config, and the per-batch train step.

Port of vit_reranking_tpu/cli/common.py for one card, with pretrained
init, resuming, step checkpoints and the device-resident image pools: the
mesh comes later.
"""

from __future__ import annotations

import os
import random
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import losses, miners
from .. import models as archs
from ..core import convert
from ..core.checkpoint import load_checkpoint, save_checkpoint
from ..core.config import Config
from ..data.device_cache import DeviceImageCache
from ..engine.train import (TrainState, cached_train_step, init_train_state, make_optimizer,
                            train_step)


# JAX package options the port does not have yet: setting one raises
UNPORTED = ("mesh_shape",)


def refuse_unported(opt: Config) -> None:
    """Raise ``NotImplementedError`` naming the first option of ``opt``
    whose effect the port lacks (meshes), rather than parse it and run
    without it."""
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


def load_pretrained_into(opt: Config, model: torch.nn.Module) -> torch.nn.Module:
    """Convert the torch checkpoint ``opt.pretrained_ckpt`` (a state dict,
    or one under ``model`` or ``state_dict``) into ``model`` when one is
    configured: the strict audit of core/convert.py first, then the converted
    entries laid over the model's own, the ones it does not cover (the fresh
    head) printed.  A path that does not exist raises
    ``FileNotFoundError`` (the JAX package skips it and trains from random
    init)."""
    if not opt.pretrained_ckpt:
        return model
    if not os.path.exists(opt.pretrained_ckpt):
        raise FileNotFoundError(f"--pretrained_ckpt {opt.pretrained_ckpt} does not exist")
    sd = torch.load(opt.pretrained_ckpt, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and hasattr(sd["model"], "keys"):
        sd = sd["model"]
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    target = model.state_dict()
    report = convert.audit_conversion(opt.arch, sd, target=target, strict=True)
    heads = report["uncovered"]
    if heads:
        print(f"[convert:{opt.arch}] {len(heads)} model entries not in the checkpoint "
              f"(a fresh head is expected): {heads[:8]}{' ...' if len(heads) > 8 else ''}")
    model.load_state_dict(convert.merge_params(target, report["converted"]))
    return model


def train_checkpoint(state: TrainState, epoch: int) -> Dict[str, Any]:
    """What a trainer checkpoint holds: the model's, the criterion's and the
    optimizer's state dicts, the step count and the epoch."""
    return {
        "params": state.model.state_dict(),
        "loss_params": state.criterion.state_dict(),
        "opt_state": state.optimizer.state_dict(),
        "step": state.step,
        "epoch": epoch,
    }


def maybe_step_checkpoint(opt: Config, run_dir: str, state: TrainState, epoch: int,
                          step: int) -> None:
    """Refresh ``{run_dir}/latest`` every ``--checkpoint_every_steps`` steps
    (``step`` counts this run's steps), so an interrupted run loses at most
    that many; resuming from it restarts the interrupted epoch."""
    every = opt.checkpoint_every_steps
    if every and step % every == 0:
        save_checkpoint(f"{run_dir}/latest", train_checkpoint(state, epoch), {})


def resume_train_state(path: str, state: TrainState) -> int:
    """Restore a trainer checkpoint into ``state``: the model, the criterion,
    the optimizer (its state moved to the parameters' device) and the step
    count, so the learning-rate schedule continues.  Entries a checkpoint
    lacks (one holding only ``params``) keep their values.  Returns the
    saved epoch (reference train_diml.py:206-213)."""
    device = next(state.model.parameters()).device
    ckpt = load_checkpoint(path, map_location=device)
    state.model.load_state_dict(ckpt["params"])
    if "loss_params" in ckpt:
        state.criterion.load_state_dict(ckpt["loss_params"])
    if "opt_state" in ckpt:
        state.optimizer.load_state_dict(ckpt["opt_state"])
    state.step = int(ckpt.get("step", state.step))
    return int(ckpt.get("epoch", 0))


def build_training(opt: Config, steps_per_epoch: int, device: torch.device,
                   img_size: int = 224):
    """Assemble ``(model, criterion, state)`` on ``device``: the model for
    ``img_size`` px inputs (the ViT's position embedding), randomly
    initialised from a generator seeded with ``opt.seed``, then
    ``--pretrained_ckpt`` converted into it, the criterion with its miner,
    and an optimizer whose groups follow :func:`build_labels`; the state
    passes the model's ``enc_out`` to a structural loss as its
    ``class_token`` under ``--use_cls_token``."""
    model = archs.select(
        opt.arch, opt, generator=torch.Generator().manual_seed(opt.seed), img_size=img_size
    )
    model = load_pretrained_into(opt, model).to(device)
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
    # the structural losses read the cls embedding (JAX cli/common.py:107)
    pass_cls = opt.loss in ("margin_diml", "multisimilarity_diml") and opt.use_cls_token
    state = init_train_state(model, criterion, optimizer, opt.tau, opt.gamma, steps_per_epoch,
                             pass_class_token=pass_cls)
    return model, criterion, state


def setup_pool(opt: Config, pool_cls, dataset, device: torch.device, tag: str):
    """``pool_cls``'s pool of ``dataset`` on ``device`` under
    ``--cache_device`` (data/device_cache.py: ``DeviceImageCache`` for the
    training split, ``DeviceEvalCache`` for the test split;
    vit_reranking_tpu/cli/common.py:115-139), else None; its size is
    printed.  A pool the card cannot hold raises the card's out-of-memory
    error: nothing falls back to the host loader."""
    if not opt.cache_device:
        return None
    pool = pool_cls.from_dataset(dataset, device, workers=opt.kernels)
    print(f"[{tag}] {pool.kind}: {tuple(pool.images.shape)} {pool.images.dtype} "
          f"({pool.nbytes / 1e9:.2f} GB resident)")
    return pool


def epoch_batches(train_loader, cache: Optional[DeviceImageCache]):
    """An epoch's (labels, images, indices) batches: the loader's, or, with
    a device pool, the sampler's indices and their labels with no image
    (vit_reranking_tpu/cli/common.py:142-153)."""
    if cache is None:
        yield from train_loader
        return
    image_list = train_loader.dataset.image_list
    for bidx in train_loader.iter_index_batches():
        yield (np.asarray([image_list[i][1] for i in bidx], np.int32), None,
               np.asarray(bidx, np.int32))


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; on a card through pinned memory, so the
    copy waits for nothing the card is still doing."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def run_train_step(state: TrainState, lab: np.ndarray, images: Optional[np.ndarray],
                   generator: Optional[torch.Generator], device: torch.device,
                   cache: Optional[DeviceImageCache] = None, idx: Optional[np.ndarray] = None):
    """Take one step: on a host batch moved to ``device`` (images to NCHW),
    or, with ``cache``, on the pool's rows ``idx``, gathered and augmented
    on the device (only the indices and labels cross from the host)."""
    y = _to_device(np.asarray(lab), device).long()
    if cache is not None:
        return cached_train_step(state, cache, _to_device(idx, device).long(), y, generator)
    x = _to_device(images, device).permute(0, 3, 1, 2)
    return train_step(state, x.contiguous(), y, generator)
