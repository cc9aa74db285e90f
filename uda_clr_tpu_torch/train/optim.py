"""Optimizers with the reference's settings (uda_clr_tpu/train/optim.py):
Adam(betas (0.9, 0.99), eps 1e-8) for the generator and SGD(momentum 0.99,
weight_decay 5e-4) for both discriminators. The learning rates are set on
the param groups every step, so the schedule stays a plain host scalar."""

from __future__ import annotations

import torch

from uda_clr_tpu_torch.config import OptimConfig


def make_gen_optimizer(params, cfg: OptimConfig) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.lr_gen, betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8)


def make_dis_optimizer(params, cfg: OptimConfig) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=cfg.lr_dis, momentum=cfg.sgd_momentum,
                           weight_decay=cfg.weight_decay)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


@torch.no_grad()
def weight_ema(teacher: torch.nn.Module, student: torch.nn.Module, alpha: float) -> None:
    """Mean-teacher shadow update ``t = alpha*t + (1-alpha)*s`` of every
    parameter, in place (optim.py:41-48)."""
    t_params, s_params = list(teacher.parameters()), list(student.parameters())
    torch._foreach_mul_(t_params, alpha)
    torch._foreach_add_(t_params, torch._foreach_mul(s_params, 1.0 - alpha))


def gen_lr_schedule(epoch: int, lr0: float, step_epochs: int = 100, rate: float = 0.2) -> float:
    """The reference's non-compounding decay: ``lr0`` before epoch 100 and
    ``rate * lr0`` from then on (optim.py:50-56)."""
    return lr0 if epoch < step_epochs else rate * lr0
