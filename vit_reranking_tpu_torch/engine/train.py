"""Training engine: the train step, the optimizer with per-group learning
rates, and the multistep schedule.

Port of vit_reranking_tpu/engine/train.py (reference train_baseline.py:
166-337) for one card: no mesh and no device-resident image cache.  The
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
    the optimizer (its state) and the step count."""

    model: nn.Module
    criterion: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[float, int], float]  # (base lr, step) -> lr
    step: int = 0


def init_train_state(model: nn.Module, criterion: nn.Module, optimizer: torch.optim.Optimizer,
                     tau: Sequence[int] = (1000,), gamma: float = 0.3,
                     steps_per_epoch: int = 1) -> TrainState:
    def schedule(base_lr: float, count: int) -> float:
        return multistep_schedule(base_lr, tau, gamma, steps_per_epoch)(count)

    return TrainState(model, criterion, optimizer, schedule)


def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One step: forward in training mode, criterion on the global embedding,
    backward, optimizer update.  Returns the loss before the update and the
    L2 norm and largest magnitude of the model's gradients
    (engine/train.py:154-165), as device scalars.

    A model parameter that the loss does not reach gets a zero gradient, as
    under ``jax.grad``, so weight decay still moves it."""
    model, criterion, optimizer = state.model, state.criterion, state.optimizer
    model.train()
    embed, _, _ = model(images)
    loss = criterion(embed, labels, generator=generator)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        group["lr"] = state.schedule(group["base_lr"], state.step)
    grads = [p.grad.float() for p in model.parameters()]
    with torch.no_grad():
        grad_l2 = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        grad_max = torch.max(torch.stack([torch.max(torch.abs(g)) for g in grads]))
    optimizer.step()
    state.step += 1
    return {"loss": loss.detach(), "grad_l2": grad_l2, "grad_max": grad_max}
