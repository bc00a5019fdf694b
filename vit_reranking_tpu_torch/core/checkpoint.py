"""Checkpoint store: the trainer's state in one ``torch.save`` file per
checkpoint directory, metrics beside it as JSON.

Port of vit_reranking_tpu/core/checkpoint.py (which uses Orbax), with the
same layout: ``{run_dir}/latest/`` and ``{run_dir}/latest.metrics.json``,
copied to ``best`` when R@1 improves.  A checkpoint holds ``params`` (the
model's ``state_dict``), ``loss_params`` (the criterion's), ``opt_state``
(the optimizer's), ``step`` and ``epoch``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"


def save_checkpoint(path: str, state: Dict[str, Any], metrics: Optional[dict] = None):
    """Save ``state`` (state dicts, step, epoch) into the directory ``path``,
    replacing what was there; ``metrics`` (plain floats) goes to
    ``path + '.metrics.json'``."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(state, os.path.join(path, STATE_FILE))
    if metrics is not None:
        with open(path + ".metrics.json", "w") as f:
            json.dump(metrics, f, indent=1)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """The state saved by :func:`save_checkpoint` into the directory
    ``path``, its tensors on ``map_location``.  Only tensors and plain
    containers are unpickled (``weights_only``)."""
    return torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                      weights_only=True)


def copy_best(run_dir: str, name: str = "latest"):
    """latest -> best copy (reference train_baseline.py:314-318)."""
    src = os.path.join(run_dir, name)
    dst = os.path.join(run_dir, "best")
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    if os.path.exists(src + ".metrics.json"):
        shutil.copyfile(src + ".metrics.json", dst + ".metrics.json")
