"""Carry the JAX package's Flax variables into the port's modules, and back.

The inverse of the torch -> Flax maps in vit_reranking_tpu/core/convert.py.
The port's modules are named after the Flax modules (``trunk/stage0/block0/
attn/conv_proj_q/conv`` becomes ``trunk.stage0.block0.attn.conv_proj_q.conv``),
so each Flax leaf maps to one parameter or buffer:

  * Conv ``kernel`` (HWIO, depthwise included) -> ``weight`` (OIHW)
  * Dense ``kernel`` (in, out)                 -> ``weight`` (out, in)
  * LayerNorm / BatchNorm ``scale``            -> ``weight``
  * BatchNorm statistics ``mean`` / ``var``    -> ``running_mean`` / ``running_var``
  * ``bias`` and other parameters (``cls_token``, Swin's 2-D
    ``relative_position_bias_table``) as they are.

The variables arrive as nested dicts of numpy arrays (``np.asarray`` of the
JAX leaves); nothing here imports JAX.  The same map carries a criterion's
parameters (the margin loss's ``beta``: ``load_jax_params(criterion,
{"params": loss_params})``).  :func:`export_params` is the inverse.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

_RENAME = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, name))
        else:
            out[name] = np.asarray(val)
    return out


def _to_torch(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T  # (in, out) -> (out, in)
    return arr


def load_jax_params(module: nn.Module, variables: Mapping) -> nn.Module:
    """Fill ``module`` from Flax ``variables`` (``{"params": ..., "batch_stats":
    ...}``).  Every parameter and statistic of the module must be filled and
    every Flax leaf consumed, with matching shapes; anything else raises."""
    leaves = {}
    for collection in ("params", "batch_stats"):
        leaves.update(_flatten(variables.get(collection, {})))
    target = module.state_dict()
    filled = {}
    for path, arr in leaves.items():
        *mods, leaf = path.split(".")
        name = ".".join([*mods, _RENAME.get(leaf, leaf)])
        if name not in target:
            raise KeyError(f"Flax leaf {path} has no counterpart {name} in the module")
        val = torch.from_numpy(np.ascontiguousarray(_to_torch(leaf, arr)))
        if tuple(val.shape) != tuple(target[name].shape):
            raise ValueError(
                f"{path}: Flax shape {tuple(arr.shape)} -> {tuple(val.shape)} does not "
                f"match {name} {tuple(target[name].shape)}"
            )
        filled[name] = val.to(target[name].dtype)
    missing = [n for n in target if n not in filled and not n.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"module entries not in the Flax variables: {missing}")
    module.load_state_dict(filled, strict=False)
    return module


def flax_name(name: str, ndim: int) -> str:
    """The Flax path (``collection/module/.../leaf``) of the module entry
    ``name`` (a parameter or buffer of ``ndim`` dimensions)."""
    *mods, leaf = name.split(".")
    collection = "params"
    if leaf in ("running_mean", "running_var"):
        collection, leaf = "batch_stats", leaf[len("running_"):]
    elif leaf == "weight":
        leaf = "kernel" if ndim in (2, 4) else "scale"
    return "/".join([collection, *mods, leaf])


def export_params(module: nn.Module) -> Dict[str, np.ndarray]:
    """The module's parameters and BatchNorm statistics in the Flax tree's
    layout, flat: ``"params/trunk/stage0/.../kernel"`` or
    ``"batch_stats/.../mean"`` -> numpy array (the inverse of
    :func:`load_jax_params`)."""
    out: Dict[str, np.ndarray] = {}
    for name, val in module.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        arr = val.detach().cpu().numpy()
        if arr.ndim == 4 and name.endswith(".weight"):
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif arr.ndim == 2 and name.endswith(".weight"):
            arr = arr.T  # (out, in) -> (in, out)
        out[flax_name(name, arr.ndim)] = np.ascontiguousarray(arr)
    return out
