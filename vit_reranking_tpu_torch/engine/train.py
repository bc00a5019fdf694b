"""Training engine: the train step, the optimizer with per-group learning
rates, and the multistep schedule.

Port of vit_reranking_tpu/engine/train.py (reference train_baseline.py:
166-337) for one card (no mesh), with the step that gathers its batch from
the device-resident image pool (``cached_train_step``).  The
JAX package's pure ``TrainState`` becomes a holder of the model, the
criterion (whose parameters are the loss's learnable state), the optimizer
and the step count, updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn


def multistep_schedule(base_lr: float, tau: Sequence[int], gamma: float,
                       steps_per_epoch: int) -> Callable[[int], float]:
    """torch MultiStepLR semantics: lr * gamma^(#milestones passed), stepped
    per epoch (train_baseline.py:119-120); a function of the step count."""
    milestones = sorted(int(t) for t in tau)

    def schedule(count: int) -> float:
        epoch = int(count) // max(steps_per_epoch, 1)
        return base_lr * gamma ** sum(epoch >= m for m in milestones)

    return schedule


def make_optimizer(opt_name: str, weight_decay: float, groups: Dict[str, List[nn.Parameter]],
                   group_lrs: Dict[str, float], momentum: float = 0.9) -> torch.optim.Optimizer:
    """One parameter group per label in ``groups`` (``model``, ``fc``,
    ``criterion``, ``frozen``), each with its base learning rate from
    ``group_lrs`` (kept as ``base_lr``; :func:`train_step` sets ``lr`` from
    the schedule before each update).

    Adam and SGD apply ``weight_decay`` as L2 on the gradient before the
    moment updates, as the JAX package's ``add_decayed_weights`` ->
    ``scale_by_adam`` / ``trace`` chain does; Adam takes optax's defaults
    (betas 0.9, 0.999, eps 1e-8).
    """
    param_groups = [
        {"params": params, "lr": group_lrs[name], "base_lr": group_lrs[name], "name": name}
        for name, params in groups.items() if params
    ]
    if opt_name == "adam":
        return torch.optim.Adam(param_groups, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    if opt_name == "sgd":
        return torch.optim.SGD(param_groups, momentum=momentum, weight_decay=weight_decay)
    raise ValueError(f"optimizer {opt_name} not supported")


@dataclasses.dataclass
class TrainState:
    """What the JAX package's TrainState holds, as live objects: the model
    (parameters and BatchNorm statistics), the criterion (loss parameters),
    the optimizer (its state) and the step count; ``pass_class_token``
    hands the model's ``enc_out`` to the criterion as ``class_token`` (the
    JAX package's ``make_train_step(pass_class_token=...)``)."""

    model: nn.Module
    criterion: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[float, int], float]  # (base lr, step) -> lr
    step: int = 0
    pass_class_token: bool = False


def init_train_state(model: nn.Module, criterion: nn.Module, optimizer: torch.optim.Optimizer,
                     tau: Sequence[int] = (1000,), gamma: float = 0.3,
                     steps_per_epoch: int = 1, pass_class_token: bool = False) -> TrainState:
    def schedule(base_lr: float, count: int) -> float:
        return multistep_schedule(base_lr, tau, gamma, steps_per_epoch)(count)

    return TrainState(model, criterion, optimizer, schedule,
                      pass_class_token=pass_class_token)


def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One step: forward in training mode, criterion on the model's first
    output (the global embedding, or a DIML model's per-patch map; with
    ``state.pass_class_token`` also on its ``enc_out`` as ``class_token``),
    backward, optimizer update.  Returns the loss before the update and the
    L2 norm and largest magnitude of the model's gradients
    (engine/train.py:154-165), as device scalars.

    A model parameter that the loss does not reach gets a zero gradient, as
    under ``jax.grad``, so weight decay still moves it."""
    model, criterion, optimizer = state.model, state.criterion, state.optimizer
    model.train()
    embed, (enc_out, _), _ = model(images)
    kwargs = {"class_token": enc_out} if state.pass_class_token else {}
    loss = criterion(embed, labels, generator=generator, **kwargs)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif p.grad.dtype != torch.float32:
                # parameters stay f32 and every cast to a compute dtype is
                # in the forward, so Adam sees f32 gradients, as in the JAX
                # package
                raise TypeError(f"a {tuple(p.shape)} parameter got a {p.grad.dtype} gradient")
        group["lr"] = state.schedule(group["base_lr"], state.step)
    grads = [p.grad.float() for p in model.parameters()]
    with torch.no_grad():
        grad_l2 = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads, 2)))
        grad_max = torch.max(torch.stack(torch._foreach_norm(grads, float("inf"))))
    optimizer.step()
    state.step += 1
    return {"loss": loss.detach(), "grad_l2": grad_l2, "grad_max": grad_max}


def cached_train_step(state: TrainState, cache, idx: torch.Tensor, labels: torch.Tensor,
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """:func:`train_step` on a batch gathered from the device-resident pool
    ``cache`` (data/device_cache.py::DeviceImageCache) at ``idx`` and
    augmented on its device (vit_reranking_tpu/engine/train.py:168-172).
    The augmentation is drawn from ``generator`` before the miner draws from
    it, as the JAX step splits its key.  Nothing here waits for the
    device."""
    return train_step(state, cache.augment(cache.images.index_select(0, idx), generator),
                      labels, generator)
