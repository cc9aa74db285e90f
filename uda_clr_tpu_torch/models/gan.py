"""PatchGAN discriminators (uda_clr_tpu/models/gan.py:25-50): five
conv(k4, s2, p2, no bias) layers 64-128-256-512-1 with LeakyReLU(0.2)
between, N(0, 0.02) init; keys ``conv1`` ... ``conv5``. NHWC in and out."""

from __future__ import annotations

import torch
import torch.nn as nn

import torch.nn.functional as F

from uda_clr_tpu_torch.models.layers import Conv2d, init_conv_
from uda_clr_tpu_torch.parallel import spatial


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
        """Under the spatial mesh the input's stripes are gathered over the
        space group and the discriminator runs whole on every space rank
        (k4 s2 p2 maps 512 rows to 257, 129, ..., which do not split into
        stripes). Its output, and so its loss L_d, is then the same on the
        group's n_space ranks; each counts 1/N in the ranks' mean, n_space/N
        = 1/n_data in all, so the mean of the ranks' losses is the global
        loss. The gather's backward sums the input's cotangent over the
        group: each stripe gets n_space * dL_d/dx, the gradient of the sum
        of the ranks' losses, and the averaged parameter gradients are those
        of the global loss (parallel/distributed.py's rule)."""
        x_nhwc = spatial.gather_rows(x_nhwc, 1)
        x = x_nhwc.permute(0, 3, 1, 2)
        with spatial.whole():
            for i in range(1, 6):
                x = getattr(self, f"conv{i}")(x)
                if i < 5:
                    x = F.leaky_relu(x, 0.2)
        return x.permute(0, 2, 3, 1)


def BoundaryDiscriminator(seed: int = 0) -> PatchDiscriminator:
    return PatchDiscriminator(1, seed)


def UncertaintyDiscriminator(seed: int = 0) -> PatchDiscriminator:
    return PatchDiscriminator(2, seed)
