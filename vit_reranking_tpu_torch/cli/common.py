"""Shared CLI wiring: seeding, model/loss/miner/optimizer assembly from a
Config, and the per-batch train step.

Port of vit_reranking_tpu/cli/common.py for one card, with pretrained
init, resuming, step checkpoints, the MSLS trainer's subcache checkpoints
and the device-resident image pools: the mesh comes later.
"""

from __future__ import annotations

import json
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


MINING_FILE = "latest_mining.npz"


def _mining_arrays(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """data/msls.py::MSLS.mining_state as numpy arrays (no pickled object):
    the generator's state as JSON text, the subcache split as its values
    and lengths."""
    out = {"rng": np.asarray(json.dumps(state["rng"])),
           "current_subset": np.asarray(state["current_subset"]),
           "nCacheSubset": np.asarray(state["nCacheSubset"])}
    if state["negCache"] is not None:
        neg = np.asarray(state["negCache"])
        if neg.dtype == object:
            raise ValueError("a ragged negative cache cannot be written as one array")
        out["negCache"] = neg
    if state["subcache_indices"] is not None:
        parts = [np.asarray(a, np.int64) for a in state["subcache_indices"]]
        out["subcache_values"] = np.concatenate(parts)
        out["subcache_lengths"] = np.asarray([len(a) for a in parts], np.int64)
    return out


def _mining_state(z) -> Dict[str, Any]:
    """Inverse of :func:`_mining_arrays` on a loaded archive."""
    subcache = None
    if "subcache_values" in z:
        subcache = np.split(z["subcache_values"], np.cumsum(z["subcache_lengths"])[:-1])
    return {"rng": json.loads(str(z["rng"])),
            "negCache": z["negCache"] if "negCache" in z else None,
            "subcache_indices": subcache,
            "current_subset": int(z["current_subset"]),
            "nCacheSubset": int(z["nCacheSubset"])}


def _global_rng_arrays(device: torch.device) -> Dict[str, np.ndarray]:
    """numpy's global generator (the trainer's triplet shuffle) and torch's
    (DropPath's draws) on the host and on ``device``, as arrays."""
    _, keys, pos, has_gauss, gauss = np.random.get_state()
    out = {"np_keys": keys, "np_rest": np.asarray([pos, has_gauss], np.int64),
           "np_gauss": np.asarray(gauss, np.float64),
           "torch_cpu": torch.get_rng_state().numpy()}
    if device.type == "cuda":
        out["torch_cuda"] = torch.cuda.get_rng_state(device).numpy()
    return out


def _set_global_rngs(z, device: torch.device) -> None:
    pos, has_gauss = (int(x) for x in z["np_rest"])
    np.random.set_state(("MT19937", z["np_keys"], pos, has_gauss, float(z["np_gauss"])))
    torch.set_rng_state(torch.from_numpy(z["torch_cpu"].copy()))
    if device.type == "cuda" and "torch_cuda" in z:
        torch.cuda.set_rng_state(torch.from_numpy(z["torch_cuda"].copy()), device)


def maybe_msls_subcache_checkpoint(opt: Config, run_dir: str, model: torch.nn.Module,
                                   optimizer: torch.optim.Optimizer, it_count: int,
                                   epoch: int, dataset, metrics=None) -> bool:
    """Under ``--checkpoint_every_steps`` (any nonzero value), save the
    trainer at a subcache boundary (vit_reranking_tpu/cli/common.py:237-276):
    the model, the optimizer, ``it_count``, ``epoch`` and the subset cursor
    into ``{run_dir}/latest``, and beside it ``latest_mining.npz``, the
    dataset's mining state (data/msls.py::MSLS.mining_state) with the
    global generators the trainer draws from (numpy's, for the triplet
    shuffle; torch's, for DropPath), as plain numpy arrays.  The subcache
    boundary is the one point where the mining state and the model agree,
    so a run resumed from it mines the same pools and triplets for every
    later subcache.  Returns True when a checkpoint was written (the
    epoch's evaluation calls this first, with ``metrics``, and saves the
    model alone when it returns False)."""
    if not opt.checkpoint_every_steps:
        return False
    save_checkpoint(f"{run_dir}/latest",
                    {"params": model.state_dict(), "opt_state": optimizer.state_dict(),
                     "it_count": it_count, "epoch": epoch,
                     "subset": int(dataset.current_subset)}, metrics or {})
    device = next(model.parameters()).device
    np.savez(os.path.join(run_dir, MINING_FILE), **_mining_arrays(dataset.mining_state()),
             **_global_rng_arrays(device))
    return True


def resume_msls_state(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer):
    """Restore an MSLS checkpoint (:func:`maybe_msls_subcache_checkpoint`'s,
    or the model alone of an epoch's ``latest``) into ``model`` and
    ``optimizer``.  Returns ``(it_count, epoch, subset, mining_state)``;
    ``mining_state`` is None, and the caller starts the epoch afresh, unless
    the checkpoint is a subcache one with its ``latest_mining.npz`` beside
    it, whose global generators are then restored too
    (vit_reranking_tpu/cli/common.py:279-325)."""
    device = next(model.parameters()).device
    ckpt = load_checkpoint(path, map_location=device)
    model.load_state_dict(ckpt["params"])
    if "opt_state" in ckpt:
        optimizer.load_state_dict(ckpt["opt_state"])
    mining = None
    archive = os.path.join(os.path.dirname(path.rstrip("/")), MINING_FILE)
    if "subset" in ckpt and os.path.exists(archive):
        with np.load(archive, allow_pickle=False) as z:
            mining = _mining_state(z)
            _set_global_rngs(z, device)
    return (int(ckpt.get("it_count", 0)), int(ckpt.get("epoch", 0)),
            int(ckpt.get("subset", 0)), mining)


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
