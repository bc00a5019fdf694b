"""Typed configuration for the port's evaluation path.

A subset of the JAX package's ``core/config.py`` (which mirrors the
reference's argparse flags, parameters.py:5-244): the fields the rollout
rerank evaluation reads, with the same names and defaults, plus ``device``.
``build_parser()`` regenerates an argparse parser from the fields and
``from_args`` parses a command line.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass
class Config:
    # ---- dataset (parameters.py:7-13)
    dataset: str = "cub200"
    # ---- general (parameters.py:16-40)
    kernels: int = 6  # host loader threads
    bs: int = 112
    seed: int = 1
    # ---- network (parameters.py:48-52)
    embed_dim: int = 128
    arch: str = "resnet50_frozen_normalize"
    # ---- DIML evaluation (parameters.py:73-120)
    grid_size: int = 7
    use_uniform: bool = False
    use_rollout: bool = False
    use_ot: bool = False
    ot_part: float = 1.0
    # ---- framework additions (JAX package core/config.py)
    synthetic_classes: int = 8
    synthetic_per_class: int = 16
    synthetic_size: int = 224
    synthetic_sep: float = 1.0
    synthetic_noise: float = 0.35
    synthetic_nuisance: float = 1.0
    approx_topk: bool = False
    # stream the rerank kernel's similarity tensor in bf16 (loop math f32)
    rerank_bf16: bool = False
    # ---- port addition: where tensors live ("cuda" or "cpu")
    device: str = "cuda"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        if isinstance(f.default, bool):
            parser.add_argument(
                name, action=argparse.BooleanOptionalAction, default=f.default
            )
        else:
            parser.add_argument(name, type=type(f.default), default=f.default)
    return parser


def from_args(argv: Optional[Sequence[str]] = None) -> Config:
    args = build_parser().parse_args(argv)
    return Config(**vars(args))
