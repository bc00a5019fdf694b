"""Torch checkpoint -> port weight converters, with a consumption audit.

Port of the ResNet-50, CvT, ViT/DeiT and Swin parts of
vit_reranking_tpu/core/convert.py.  The reference trains from
ImageNet/DeiT/Swin torch checkpoints (reference architectures/resnet50.py,
cvt.py:695-722, vit.py:31-40, swin.py:23-37).  The JAX
package maps their keys onto Flax trees; here each key maps straight onto a
``state_dict`` name of the port's model, which follows the Flax module
names (``stage2.blocks.9.attn.conv_proj_q.conv.weight`` becomes
``trunk.stage2.block9.attn.conv_proj_q.conv.weight``).  Both sides are
torch layouts, so no value is transposed: a converter returns a flat
``{name: tensor}`` dict.

:func:`audit_conversion` runs a converter over a :class:`TrackedStateDict`
and holds the result against the model's ``state_dict()``: keys the
converter needs that the checkpoint lacks, checkpoint keys it never read
(beyond :data:`IGNORABLE_UNCONSUMED`), and names or shapes the model does
not have are faults; model entries the checkpoint does not cover (the fresh
embedding head) are reported.  :func:`merge_params` lays the converted
entries over the model's own.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _t(v) -> torch.Tensor:
    """A checkpoint value as a tensor (a tensor as it is; numpy converted)."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.from_numpy(np.asarray(v))


class TrackedStateDict(dict):
    """A state_dict that records which ORIGINAL checkpoint keys a converter
    actually reads.

    Reads via ``[]``/``get`` mark the key consumed; plain iteration
    (``items``/``keys``/``in``) does not.  ``strip_prefix`` threads the
    tracking through its key renames.  The port's converters only read, so
    the JAX package's ``sd[new] = sd.pop(old)`` rename tracking has no
    counterpart here."""

    def __init__(self, data=(), consumed=None, origin=None):
        super().__init__(data)
        self.consumed = set() if consumed is None else consumed
        self._origin = {k: k for k in self} if origin is None else origin

    def __getitem__(self, k):
        v = super().__getitem__(k)
        self.consumed.add(self._origin.get(k, k))
        return v

    def get(self, k, default=None):
        if super().__contains__(k):
            return self[k]
        return default

    def unconsumed(self):
        """Original-key names never read by the converter."""
        live = {self._origin.get(k, k) for k in self}
        return sorted(live - self.consumed)


def strip_prefix(state_dict: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """Drop a leading prefix (e.g. 'model.' or 'module.') from every key
    (reference utilities/misc.py:58-62).  A :class:`TrackedStateDict` input
    stays tracked: the stripped copy shares the consumed set and maps each
    new key back to its original name."""
    if isinstance(state_dict, TrackedStateDict):
        items, origin = {}, {}
        for k in state_dict:  # plain iteration: no consumption marking
            nk = k[len(prefix):] if k.startswith(prefix) else k
            items[nk] = dict.__getitem__(state_dict, k)
            origin[nk] = state_dict._origin.get(k, k)
        return TrackedStateDict(items, consumed=state_dict.consumed, origin=origin)
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in state_dict.items()}


def convert_cvt(state_dict: Mapping[str, Any], num_stages: int = 3, depths=(1, 2, 10),
                include_head: bool = True) -> Dict[str, torch.Tensor]:
    """Official CvT-13 checkpoint (reference naming, architectures/cvt.py:
    556-606) -> the port's CvTNetwork entries: the ``trunk`` stages, the
    final ``norm``, and the classifier ``head`` when ``include_head``."""
    sd = strip_prefix(state_dict, "model.")
    out: Dict[str, torch.Tensor] = {}
    for i in range(num_stages):
        sp, dp = f"stage{i}", f"trunk.stage{i}"
        out[f"{dp}.patch_embed_proj.weight"] = _t(sd[f"{sp}.patch_embed.proj.weight"])
        out[f"{dp}.patch_embed_proj.bias"] = _t(sd[f"{sp}.patch_embed.proj.bias"])
        out[f"{dp}.patch_embed_norm.ln.weight"] = _t(sd[f"{sp}.patch_embed.norm.weight"])
        out[f"{dp}.patch_embed_norm.ln.bias"] = _t(sd[f"{sp}.patch_embed.norm.bias"])
        if f"{sp}.cls_token" in sd:
            out[f"{dp}.cls_token"] = _t(sd[f"{sp}.cls_token"])
        for j in range(depths[i]):
            bp, fp = f"{sp}.blocks.{j}", f"{dp}.block{j}"
            for ln in ("norm1", "norm2"):
                for leaf in ("weight", "bias"):
                    out[f"{fp}.{ln}.ln.{leaf}"] = _t(sd[f"{bp}.{ln}.{leaf}"])
            for proj in ("conv_proj_q", "conv_proj_k", "conv_proj_v"):
                src, dst = f"{bp}.attn.{proj}", f"{fp}.attn.{proj}"
                out[f"{dst}.conv.weight"] = _t(sd[f"{src}.conv.weight"])
                for leaf in ("weight", "bias", "running_mean", "running_var"):
                    out[f"{dst}.bn.{leaf}"] = _t(sd[f"{src}.bn.{leaf}"])
            for lin in ("proj_q", "proj_k", "proj_v", "proj"):
                out[f"{fp}.attn.{lin}.weight"] = _t(sd[f"{bp}.attn.{lin}.weight"])
                if f"{bp}.attn.{lin}.bias" in sd:
                    out[f"{fp}.attn.{lin}.bias"] = _t(sd[f"{bp}.attn.{lin}.bias"])
            for fc in ("fc1", "fc2"):
                for leaf in ("weight", "bias"):
                    out[f"{fp}.mlp.{fc}.{leaf}"] = _t(sd[f"{bp}.mlp.{fc}.{leaf}"])
    if "norm.weight" in sd:
        out["norm.ln.weight"] = _t(sd["norm.weight"])
        out["norm.ln.bias"] = _t(sd["norm.bias"])
    if include_head and "head.weight" in sd:
        out["head.weight"] = _t(sd["head.weight"])
        out["head.bias"] = _t(sd["head.bias"])
    if "last_linear.weight" in sd:
        # DIML 1x1-conv head (O, I, 1, 1) -> a linear layer (O, I)
        out["last_linear.weight"] = _t(sd["last_linear.weight"])[:, :, 0, 0]
        out["last_linear.bias"] = _t(sd["last_linear.bias"])
    return out


def zoom_pos_embed(pos, new_grid: int) -> torch.Tensor:
    """Resize a (1, 1 + g_old^2, C) position embedding to a new grid size:
    cls slot kept, grid part spline-zoomed order=1 (reference
    architectures/cvt.py:574-603, scipy.ndimage.zoom)."""
    import scipy.ndimage

    pos = _t(pos).numpy()
    tok, grid = pos[:, :1], pos[0, 1:]
    gs_old = int(np.sqrt(len(grid)))
    if gs_old == new_grid:
        return torch.from_numpy(pos)
    grid = grid.reshape(gs_old, gs_old, -1)
    grid = scipy.ndimage.zoom(grid, (new_grid / gs_old, new_grid / gs_old, 1), order=1)
    return torch.from_numpy(np.concatenate([tok, grid.reshape(1, new_grid**2, -1)], axis=1))


def convert_vit(state_dict: Mapping[str, Any], depth: int = 12,
                target_grid: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """timm DeiT/ViT checkpoint (the layout reference architectures/vit.py:
    31-40 consumes) -> the port's ViTNetwork entries.  ``target_grid`` zooms
    the position embedding to another token grid."""
    sd = strip_prefix(state_dict, "module.")
    out: Dict[str, torch.Tensor] = {
        "patch_embed_proj.weight": _t(sd["patch_embed.proj.weight"]),
        "patch_embed_proj.bias": _t(sd["patch_embed.proj.bias"]),
        "cls_token": _t(sd["cls_token"]),
    }
    pos = _t(sd["pos_embed"])
    out["pos_embed"] = pos if target_grid is None else zoom_pos_embed(pos, target_grid)
    for i in range(depth):
        bp, fp = f"blocks.{i}", f"block{i}"
        for name in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            for leaf in ("weight", "bias"):
                out[f"{fp}.{name}.{leaf}"] = _t(sd[f"{bp}.{name}.{leaf}"])
    out["norm.weight"] = _t(sd["norm.weight"])
    out["norm.bias"] = _t(sd["norm.bias"])
    return out


def convert_swin(state_dict: Mapping[str, Any], depths=(2, 2, 6, 2)) -> Dict[str, torch.Tensor]:
    """timm/microsoft swin_tiny checkpoint -> the port's SwinNetwork entries
    (the relative-position bias tables as they are, (169, heads))."""
    sd = strip_prefix(state_dict, "module.")
    out: Dict[str, torch.Tensor] = {}
    for name in ("patch_embed.proj", "patch_embed.norm"):
        for leaf in ("weight", "bias"):
            out[f"{name.replace('.', '_')}.{leaf}"] = _t(sd[f"{name}.{leaf}"])
    for li, depth in enumerate(depths):
        for bi in range(depth):
            src, dst = f"layers.{li}.blocks.{bi}", f"layer{li}_block{bi}"
            out[f"{dst}.attn.relative_position_bias_table"] = _t(
                sd[f"{src}.attn.relative_position_bias_table"])
            for name in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
                for leaf in ("weight", "bias"):
                    out[f"{dst}.{name}.{leaf}"] = _t(sd[f"{src}.{name}.{leaf}"])
        if li < len(depths) - 1:
            src, dst = f"layers.{li}.downsample", f"layer{li}_downsample"
            out[f"{dst}.norm.weight"] = _t(sd[f"{src}.norm.weight"])
            out[f"{dst}.norm.bias"] = _t(sd[f"{src}.norm.bias"])
            out[f"{dst}.reduction.weight"] = _t(sd[f"{src}.reduction.weight"])
    out["norm.weight"] = _t(sd["norm.weight"])
    out["norm.bias"] = _t(sd["norm.bias"])
    return out


def convert_resnet50(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """torchvision / pretrainedmodels ResNet-50 checkpoint (``module.`` and
    ``model.`` prefixes stripped) -> the port's ResNet-50 trunk entries
    (JAX convert.py:236-262): ``layer2.0.downsample.0`` becomes
    ``trunk.layer2_0.downsample_conv``, ``downsample.1`` the
    ``downsample_bn``; BatchNorm statistics included.  The ImageNet
    classifier (``fc``, or pretrainedmodels' ``last_linear``) is not read."""
    sd = strip_prefix(strip_prefix(state_dict, "module."), "model.")
    out: Dict[str, torch.Tensor] = {}

    def bn(src: str, dst: str) -> None:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.{leaf}"] = _t(sd[f"{src}.{leaf}"])

    out["trunk.conv1.weight"] = _t(sd["conv1.weight"])
    bn("bn1", "trunk.bn1")
    for li, blocks in enumerate((3, 4, 6, 3)):
        for bi in range(blocks):
            src, dst = f"layer{li + 1}.{bi}", f"trunk.layer{li + 1}_{bi}"
            for ci in (1, 2, 3):
                out[f"{dst}.conv{ci}.weight"] = _t(sd[f"{src}.conv{ci}.weight"])
                bn(f"{src}.bn{ci}", f"{dst}.bn{ci}")
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.downsample_conv.weight"] = _t(sd[f"{src}.downsample.0.weight"])
                bn(f"{src}.downsample.1", f"{dst}.downsample_bn")
    return out


# the JAX package's converter families whose models the port does not have
_UNPORTED_FAMILIES = ("irresnet50", "netvlad", "densenet", "googlenet", "bninception")


def convert_for_arch(arch: str, sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Arch string -> converter (the routing of the reference,
    architectures/__init__.py:11-34); the classifier head is never carried
    over (the DML head is fresh)."""
    a = arch.lower()
    if a.startswith("resnet50"):
        return convert_resnet50(sd)
    if a.startswith("cvt"):
        return convert_cvt(sd, include_head=False)
    if a.startswith("vit") or a.startswith("deit"):
        return convert_vit(sd)
    if "swin" in a:
        return convert_swin(sd)
    if any(f in a for f in _UNPORTED_FAMILIES):
        raise NotImplementedError(
            f"converter for {arch} is not ported: the port has no model for it")
    raise NotImplementedError(f"converter for {arch} pending")


# Checkpoint keys real released .pth files carry that the converters skip on
# purpose: classification heads replaced by the fresh DML head (reference
# load_state_dict(strict=False), cvt.py:713-722) and torch bookkeeping
# buffers the models recompute.
IGNORABLE_UNCONSUMED = (
    "num_batches_tracked",      # torch BN step counter
    "head.weight", "head.bias",  # ImageNet classifier (replaced)
    "fc.weight", "fc.bias",      # torchvision resnet/googlenet classifier
    "classifier.weight", "classifier.bias",  # torchvision densenet
    "head_dist.", "dist_token",  # DeiT distillation branch (unused, vit.py:31)
    "attn_mask",                 # swin shift-mask buffer (recomputed)
    "relative_position_index",   # swin index buffer (recomputed)
    "aux1.", "aux2.",            # googlenet aux classifiers (eval never runs)
    "pre_logits.",               # timm ViT representation layer (unused)
    "last_linear.",              # pretrainedmodels' ImageNet classifier
)


class ConversionAuditError(ValueError):
    """A converter audit failed; the message names every offending key."""


def audit_conversion(arch: str, state_dict: Mapping[str, Any],
                     target: Optional[Mapping[str, torch.Tensor]] = None,
                     strict: bool = True) -> Dict[str, Any]:
    """Dry-run the converter for ``arch`` under a consumption audit.

    Checks a checkpoint's ``state_dict`` for:
      * missing keys: the converter read a key the checkpoint lacks;
      * unconsumed keys: checkpoint keys no rule read, minus
        :data:`IGNORABLE_UNCONSUMED` (a renamed submodule leaves its whole
        subtree here);
      * structural extras and shape mismatches: converted entries that
        ``target`` (the model's ``state_dict()``) lacks or holds in another
        shape;
      * uncovered entries: ``target`` parameters and statistics the
        checkpoint does not provide (expected for the fresh head; reported,
        not a fault).

    Returns a report with the converted entries under ``converted``; with
    ``strict`` raises :class:`ConversionAuditError` on any fault."""
    tracked = TrackedStateDict(dict(state_dict.items()))
    try:
        converted = convert_for_arch(arch, tracked)
    except KeyError as e:
        raise ConversionAuditError(
            f"[convert:{arch}] checkpoint is MISSING key {e.args[0]!r} that the "
            f"converter requires: wrong checkpoint family, or a transcription "
            f"divergence.  Checkpoint has {len(state_dict)} keys; run "
            f"audit_conversion(strict=False) for the full map."
        ) from e

    unconsumed_all = tracked.unconsumed()
    ignored = [k for k in unconsumed_all if any(p in k for p in IGNORABLE_UNCONSUMED)]
    unconsumed = [k for k in unconsumed_all if k not in set(ignored)]

    shape_mismatches, extras, uncovered = [], [], []
    if target is not None:
        for k, v in converted.items():
            if k not in target:
                extras.append(k)
            elif tuple(target[k].shape) != tuple(v.shape):
                shape_mismatches.append(
                    f"{k}: model {tuple(target[k].shape)} vs ckpt {tuple(v.shape)}")
        uncovered = sorted(k for k in target
                           if k not in converted and not k.endswith("num_batches_tracked"))

    problems = []
    if unconsumed:
        problems.append(f"{len(unconsumed)} checkpoint keys were never consumed "
                        f"(first 20): {unconsumed[:20]}")
    if shape_mismatches:
        problems.append(f"{len(shape_mismatches)} shape mismatches: {shape_mismatches[:20]}")
    if extras:
        problems.append(f"{len(extras)} converted entries have no model counterpart "
                        f"(first 20): {extras[:20]}")
    if problems and strict:
        raise ConversionAuditError(f"[convert:{arch}] audit failed:\n  - "
                                   + "\n  - ".join(problems))
    return {
        "arch": arch,
        "n_keys": len(state_dict),
        "n_consumed": len(tracked.consumed),
        "unconsumed": unconsumed,
        "ignored_unconsumed": ignored,
        "shape_mismatches": shape_mismatches,
        "structural_extras": extras,
        "uncovered": uncovered,
        "converted": converted,
        "problems": problems,
    }


def merge_params(base: Mapping[str, torch.Tensor],
                 override: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``base`` (a model's ``state_dict()``) with the entries of ``override``
    laid over it; entries the checkpoint lacks keep their initial values, as
    the reference's ``load_state_dict(strict=False)`` with a fresh head
    (architectures/cvt.py:713-722)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and tuple(out[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch for {k}: model {tuple(out[k].shape)} "
                             f"vs ckpt {tuple(v.shape)}")
        out[k] = v
    return out
