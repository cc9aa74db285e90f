"""The config fields the port's train steps read (own copy of
uda_clr_tpu/config.py:18-116's ModelConfig, OptimConfig and MethodConfig
subset; defaults identical)."""

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
    # ablation switches (uda_clr_tpu/train/steps.py:make_train_step)
    use_adv: bool = True  # False: no discriminator game (Trainer_MT_wo_ad)
    use_boundary_d: bool = True  # boundary PatchGAN
    use_entropy_d: bool = True  # entropy PatchGAN; method='posal' forces False
    use_boundary_loss: bool = True  # False: no MSE boundary term (Trainer_baseline_wob)
    # prototype stack (prototype_full, prototype_mt)
    use_global: bool = True
    retrify_pseudo: bool = True
    pro_weight: float = 0.1
    global_pro_weight: float = 0.9
    mc_samples: int = 8  # T
    mc_fast: bool = True
    std_threshold: float = 0.04
    pseudo_threshold: float = 0.75
    # intra-domain category regularization (prototype_mt)
    use_trg_cons: bool = True
    aug_weight: float = 0.1
    aug_backward: bool = False  # True: add aug_weight * loss_aug to the G loss
    src_reg: bool = True
    src_reg_weight: float = 0.01
    # mean teacher
    ema_decay: float = 0.99
    consistency: float = 1.0
    teacher_noise: float = 0.1  # sigma of the gaussian noise on the teacher's input


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    method: MethodConfig = field(default_factory=MethodConfig)
