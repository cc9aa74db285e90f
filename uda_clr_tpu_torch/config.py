"""The config fields the flagship train step reads (own copy of
uda_clr_tpu/config.py's ModelConfig, OptimConfig and MethodConfig subset;
defaults identical)."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class ModelConfig:
    num_classes: int = 2
    backbone: str = "mobilenet"  # this slice: mobilenet only
    output_stride: int = 16
    norm: str = "bn"  # this slice: plain BN only
    compute_dtype: str = "float32"  # 'bfloat16' for the card

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


@dataclass
class OptimConfig:
    lr_gen: float = 1e-3
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    lr_dis: float = 2.5e-5
    sgd_momentum: float = 0.99
    weight_decay: float = 5e-4


@dataclass
class MethodConfig:
    adv_weight: float = 0.01
    use_global: bool = True
    retrify_pseudo: bool = True
    pro_weight: float = 0.1
    global_pro_weight: float = 0.9
    mc_samples: int = 8  # T
    mc_fast: bool = True
    std_threshold: float = 0.04
    pseudo_threshold: float = 0.75


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    method: MethodConfig = field(default_factory=MethodConfig)
