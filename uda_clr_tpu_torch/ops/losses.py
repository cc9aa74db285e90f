"""Loss primitives (uda_clr_tpu/ops/losses.py)."""

from __future__ import annotations

import torch


class _BceSigmoidStable(torch.autograd.Function):
    """Value: ``BCELoss(sigmoid(x), t)`` with torch's -100 log clamp
    (including float32 sigmoid saturation at |x| >= ~17). Gradient: the
    unclamped ``(sigmoid(x) - t) / N``, bounded for every logit
    (losses.py:29-63)."""

    @staticmethod
    def forward(ctx, logits, targets):
        ctx.save_for_backward(logits, targets)
        p = torch.sigmoid(logits)
        log_p = torch.clamp(torch.log(p), min=-100.0)
        log_1p = torch.clamp(torch.log1p(-p), min=-100.0)
        return -torch.mean(targets * log_p + (1.0 - targets) * log_1p)

    @staticmethod
    def backward(ctx, g):
        logits, targets = ctx.saved_tensors
        grad = (torch.sigmoid(logits) - targets) / logits.numel()
        return g * grad, None


def bce_sigmoid_stable(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return _BceSigmoidStable.apply(logits, targets)


class _BceSigmoidStableElementwise(torch.autograd.Function):
    """Elementwise ``BCELoss(sigmoid(x), t)`` with the -100 log clamp in the
    value and the bounded gradient ``g * (sigmoid(x) - t)`` (losses.py
    :85-104)."""

    @staticmethod
    def forward(ctx, logits, targets):
        ctx.save_for_backward(logits, targets)
        p = torch.sigmoid(logits)
        log_p = torch.clamp(torch.log(p), min=-100.0)
        log_1p = torch.clamp(torch.log1p(-p), min=-100.0)
        return -(targets * log_p + (1.0 - targets) * log_1p)

    @staticmethod
    def backward(ctx, g):
        logits, targets = ctx.saved_tensors
        return g * (torch.sigmoid(logits) - targets), None


def bce_sigmoid_stable_elementwise(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return _BceSigmoidStableElementwise.apply(logits, targets)


def bce_with_logits_elementwise(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``max(x,0) - x t + log(1 + exp(-|x|))``."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean(bce_with_logits_elementwise(logits, targets))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def entropy_map(mask_logits: torch.Tensor, smooth: float = 1e-7) -> torch.Tensor:
    """Per-pixel ``-p * log(p + eps)`` fed to the uncertainty discriminator."""
    p = torch.sigmoid(mask_logits)
    return -1.0 * p * torch.log(p + smooth)
