"""PatchGAN discriminators (uda_clr_tpu/models/gan.py:25-50): five
conv(k4, s2, p2, no bias) layers 64-128-256-512-1 with LeakyReLU(0.2)
between, N(0, 0.02) init; keys ``conv1`` ... ``conv5``. NHWC in and out."""

from __future__ import annotations

import torch
import torch.nn as nn

import torch.nn.functional as F

from uda_clr_tpu_torch.models.layers import Conv2d, init_conv_


class PatchDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 2, seed: int = 0):
        super().__init__()
        chans = (in_channels, 64, 128, 256, 512, 1)
        g = torch.Generator().manual_seed(seed)
        for i in range(5):
            conv = Conv2d(chans[i], chans[i + 1], 4, 2, 2, bias=False)
            init_conv_(conv, g, std=0.02)
            self.add_module(f"conv{i + 1}", conv)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)
        for i in range(1, 6):
            x = getattr(self, f"conv{i}")(x)
            if i < 5:
                x = F.leaky_relu(x, 0.2)
        return x.permute(0, 2, 3, 1)


def BoundaryDiscriminator(seed: int = 0) -> PatchDiscriminator:
    return PatchDiscriminator(1, seed)


def UncertaintyDiscriminator(seed: int = 0) -> PatchDiscriminator:
    return PatchDiscriminator(2, seed)
