"""Shared conv building blocks (uda_clr_tpu/models/layers.py).

Modules are NCHW; on the card they hold ``torch.channels_last`` tensors,
which are physically NHWC. Parameters stay float32; every conv casts its
weight to the activation dtype (the JAX package's ``dtype=bfloat16`` with
``param_dtype=float32``). The port takes explicit casts, not autocast:
activations are cast once at the model input and stay in that dtype.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from uda_clr_tpu_torch.models.norm import DomainNorm2d


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 weight (and bias) is cast to the input's
    dtype, as flax's ``nn.Conv(dtype=..., param_dtype=float32)`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


def init_conv_(conv: nn.Conv2d, generator: torch.Generator, std: float | None = None):
    """JAX-package init: kaiming-normal fan_in (gain^2=2) or N(0, std)
    (the discriminators' N(0, 0.02)); zero bias."""
    with torch.no_grad():
        if std is None:
            nn.init.kaiming_normal_(conv.weight, mode="fan_in",
                                    nonlinearity="relu", generator=generator)
        else:
            nn.init.normal_(conv.weight, 0.0, std, generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()


def fixed_padding(x: torch.Tensor, kernel_size: int, dilation: int) -> torch.Tensor:
    """Pre-pad for 'same' output under stride (layers.py:57-68). MobileNet
    pads the *block input*, so the expansion conv's BN sees the border."""
    k_eff = kernel_size + (kernel_size - 1) * (dilation - 1)
    pad_total = k_eff - 1
    beg = pad_total // 2
    end = pad_total - beg
    return F.pad(x, (beg, end, beg, end))


# Every dropout an identity while BN stays in train mode: the counterpart of
# uda_clr_tpu's set_dropout_impl('off'), for parity tests only (the two
# frameworks' random streams cannot coincide).
_DROPOUT_OFF = False


def set_dropout_off(off: bool) -> None:
    global _DROPOUT_OFF
    _DROPOUT_OFF = bool(off)


def dropout_off() -> bool:
    return _DROPOUT_OFF


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            train: bool = True) -> torch.Tensor:
    """Exact-rate dropout drawn from ``generator`` (zero with prob ``rate``,
    survivors scaled by 1/keep, computed in float32 and rounded once). The
    draws take ``x``'s memory format, so a channels_last activation stays
    channels_last."""
    if not train or rate == 0.0 or _DROPOUT_OFF:
        return x
    keep = 1.0 - rate
    u = torch.empty_like(x, dtype=torch.float32).uniform_(generator=generator)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """Parameter-free slot with the reference's index in its Sequential."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool, generator: torch.Generator | None):
        return dropout(x, self.rate, generator, train)


def run_layers(layers, x, train: bool, domains: int, generator=None):
    """Apply a reference-indexed layer list: norms take (train, domains),
    dropouts (train, generator), everything else x alone."""
    for layer in layers:
        if isinstance(layer, DomainNorm2d):
            x = layer(x, train, domains)
        elif isinstance(layer, Dropout):
            x = layer(x, train, generator)
        else:
            x = layer(x)
    return x
