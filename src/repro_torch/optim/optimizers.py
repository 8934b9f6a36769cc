"""The optimizer settings of an arch spec (a copy of ``repro``'s
``OptimizerConfig``, field for field)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor | sgd
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    accum_steps: int = 1
    # adafactor
    factored_dims_min: int = 2
    decay_rate: float = 0.8
