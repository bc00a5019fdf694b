"""Typed configuration for the port's evaluation and training paths.

A subset of the JAX package's ``core/config.py`` (which mirrors the
reference's argparse flags, parameters.py:5-244): the fields the rerank
evaluation (rollout, featvit and qk methods) and the margin-loss training
read, with the same names and defaults, plus ``device``.  ``build_parser()`` regenerates an argparse parser
from the fields and ``from_args`` parses a command line.
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
    # ---- loss / mining (parameters.py:43-45)
    optim: str = "adam"
    loss: str = "margin"
    batch_mining: str = "distance"
    # ---- network (parameters.py:48-52)
    embed_dim: int = 128
    arch: str = "resnet50_frozen_normalize"
    # ---- setup (parameters.py:67-70); the default save_path is the working
    # directory's Training_Results, as in the JAX package
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
    temperature: float = 0.1
    ot_part: float = 1.0
    debug: bool = False
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
    # bf16 activation training and the narrowed softmax.  Tri-state as in the
    # JAX package, whose CLI turns both off away from the TPU; the port
    # trains f32 and refuses True (bf16 training is later work).
    bf16: Optional[bool] = None
    narrow_sm: Optional[bool] = None
    # JAX package options the port does not have yet: setting one raises
    cache_device: bool = False
    mesh_shape: Optional[str] = None
    checkpoint_every_steps: int = 0
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
