"""Typed configuration for the port's evaluation and training paths.

A subset of the JAX package's ``core/config.py`` (which mirrors the
reference's argparse flags, parameters.py:5-244): the fields the rerank
evaluation (rollout, featvit and qk methods), the margin-loss training, the
MSLS training and evaluation, the image-tree datasets, checkpoints and
pretrained init read, with the same names and defaults, plus ``device``.
``build_parser()`` regenerates an argparse parser from the fields and
``from_args`` parses a command line.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass
class Config:
    # ---- dataset (parameters.py:7-13)
    dataset: str = "cub200"
    augmentation: str = "base"  # training transform preset: base, adv, big, red
    # ---- general training (parameters.py:16-40)
    lr: float = 0.00001
    fc_lr: float = -1.0
    decay: float = 0.0004
    n_epochs: int = 150
    kernels: int = 6  # host loader threads
    bs: int = 112
    seed: int = 1
    gamma: float = 0.3
    tau: List[int] = field(default_factory=lambda: [1000])
    resume_path: Optional[str] = None
    start_epoch: int = 0
    evalevery: int = 10
    max_patience: int = 100
    # ---- MSLS training (parameters.py:16-40): the mining cache's embedding
    # batch, the step schedule lr * lrgamma ** ((count // 1000) // lrstep),
    # coupled weight decay and SGD's momentum, the triplet margin, the
    # negatives a triplet takes, and the images' (h, w)
    cachebatchsize: int = 20
    lrstep: int = 20
    lrgamma: float = 0.5
    weightdecay: float = 0.001
    momentum: float = 0.9
    margin: float = 0.1
    nNeg: int = 5
    imageresizew: int = 640
    imageresizeh: int = 480
    # ---- loss / mining (parameters.py:43-45)
    optim: str = "adam"
    loss: str = "margin"
    batch_mining: str = "distance"
    # ---- network (parameters.py:48-52)
    embed_dim: int = 128
    arch: str = "resnet50_frozen_normalize"
    # ---- setup (parameters.py:67-70); the default save_path is the working
    # directory's Training_Results, as in the JAX package
    source_path: str = os.getcwd() + "/data"  # datasets live in source_path/<dataset>
    save_path: str = os.getcwd() + "/Training_Results"
    group: str = "default"
    # ---- ViT / DIML evaluation (parameters.py:73-120)
    blk_ind: int = 0  # ViT block whose q/k the qk method reads
    grid_size: int = 7
    use_cls_token: bool = False
    use_uniform: bool = False
    use_inverse: bool = False
    use_minus: bool = False
    use_soft: bool = False
    use_rollout: bool = False
    use_ot: bool = False
    # evaluate a DIML model: its per-patch output is the bank, its enc_out
    # the center (the reference's training_mode)
    training: bool = False
    temperature: float = 0.1
    ot_part: float = 1.0
    debug: bool = False
    # the MSLS trainer's task loss and its weight; distillation, the
    # cross-batch memory and feature-drift tracking are JAX package options
    # the port does not have yet: the MSLS CLIs refuse them
    task_loss: str = "triplet"
    distill: Optional[str] = None
    kd_weight: float = 1.0
    tl_weight: float = 1.0
    enable_xbm: bool = False
    xbm_start_iteration: int = 1000
    xbm_size: int = 10000
    xbm_weight: float = 1.0
    track_drift: bool = False
    # ---- MSLS sequence tasks and subtasks (training_tools/msls.py:76-133),
    # the synthetic MSLS set's image side, and --mini_data (one city, amman)
    msls_task: str = "im2im"
    msls_seq_length: int = 1
    msls_subtask: str = "all"
    msls_image_size: int = 64
    mini_data: bool = False
    # ---- margin loss and distance miner (parameters.py:147-224)
    loss_margin_margin: float = 0.2
    loss_margin_beta_lr: float = 0.0005
    loss_margin_beta: float = 1.2
    loss_margin_nu: float = 0.0
    loss_margin_beta_constant: bool = False
    miner_distance_lower_cutoff: float = 0.5
    miner_distance_upper_cutoff: float = 1.4
    # ---- batch creation (parameters.py:228-243)
    data_sampler: str = "class_random"
    samples_per_class: int = 2
    # ---- framework additions (JAX package core/config.py)
    n_classes: int = 0  # filled in by the dataset
    synthetic_classes: int = 8
    synthetic_per_class: int = 16
    synthetic_size: int = 224
    synthetic_sep: float = 1.0
    synthetic_noise: float = 0.35
    synthetic_nuisance: float = 1.0
    approx_topk: bool = False
    use_qk: bool = False  # ViT attention-marginal rerank (eval_attn_diml path)
    # stream the rerank kernel's similarity tensor in bf16 (loop math f32)
    rerank_bf16: bool = False
    # bf16 activations (f32 parameters, BatchNorm statistics, LayerNorms and
    # head) and the narrowed softmax (materialised attention scores in bf16).
    # Tri-state as in the JAX package: None takes the training CLI's default,
    # resolve_precision (on the card, bf16 for the arches the JAX package
    # trains in bf16 on its accelerator; f32 on the CPU); narrow_sm follows
    # bf16.  The evaluation CLI reads both as they are given (None is off),
    # as the JAX evaluation does.
    bf16: Optional[bool] = None
    narrow_sm: Optional[bool] = None
    # refresh `latest` between evaluations: at the end of every epoch, and
    # every N optimizer steps (0: never)
    save_every_epoch: bool = False
    checkpoint_every_steps: int = 0
    # a torch checkpoint of the reference's backbone (ImageNet weights),
    # converted into the model at init (core/convert.py)
    pretrained_ckpt: Optional[str] = None
    # the device-resident image pools (data/device_cache.py): training
    # gathers and augments its batches on the card, evaluation embeds from
    # the pool
    cache_device: bool = False
    # a JAX package option the port does not have yet: setting it raises
    mesh_shape: Optional[str] = None
    # ---- port addition: where tensors live ("cuda" or "cpu")
    device: str = "cuda"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        if isinstance(f.default, bool) or f.name in ("bf16", "narrow_sm"):
            parser.add_argument(
                name, action=argparse.BooleanOptionalAction, default=f.default
            )
        elif f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
            parser.add_argument(name, nargs="+", type=type(default[0]), default=default)
        else:
            kind = type(f.default) if f.default is not None else str
            parser.add_argument(name, type=kind, default=f.default)
    return parser


def from_args(argv: Optional[Sequence[str]] = None) -> Config:
    args = build_parser().parse_args(argv)
    return Config(**vars(args))


def resolve_precision(opt: Config) -> Config:
    """``opt`` with ``bf16`` and ``narrow_sm`` resolved where they are None,
    as the JAX package's training CLI resolves them
    (vit_reranking_tpu/cli/train_baseline.py:67-92), with "the device is
    CUDA" in place of "the backend is a TPU": bf16 for ``cvt*`` (not
    ``*diml*``), ``resnet50*``, ``irresnet50*``, ``vit*``/``deit*`` and
    ``*swin*`` on the card, f32 elsewhere and on the CPU; ``narrow_sm``
    follows ``bf16``.  An explicit ``--bf16``/``--no-bf16`` (or
    ``--narrow_sm``/``--no-narrow_sm``) stands."""
    if opt.bf16 is None:
        a = opt.arch
        on_card = opt.device.split(":")[0] == "cuda"
        opt = opt.replace(bf16=on_card and (
            (a.startswith("cvt") and "diml" not in a)
            or a.startswith(("resnet50", "irresnet50", "vit", "deit"))
            or "swin" in a))
    if opt.narrow_sm is None:
        opt = opt.replace(narrow_sm=bool(opt.bf16))
    return opt


def resolve_diml_precision(opt: Config) -> Config:
    """``opt`` with ``bf16`` and ``narrow_sm`` resolved where they are None,
    as the JAX package's DIML training CLI resolves them
    (vit_reranking_tpu/cli/train_diml.py:74-85), "the device is CUDA" for
    "the backend is a TPU": bf16 for every ``cvt*`` arch, ``*diml*``
    included, ``resnet50*`` and ``irresnet50*`` on the card (the per-patch
    head and the structural loss stay f32), f32 elsewhere and on the CPU;
    ``narrow_sm`` follows ``bf16``.  Explicit flags stand."""
    if opt.bf16 is None:
        on_card = opt.device.split(":")[0] == "cuda"
        opt = opt.replace(bf16=on_card and opt.arch.startswith(("cvt", "resnet50", "irresnet50")))
    if opt.narrow_sm is None:
        opt = opt.replace(narrow_sm=bool(opt.bf16))
    return opt
