"""DRN-D-54 backbone (uda_clr_tpu/models/drn.py:19-97): arch 'D', plain
3x3 conv layers 1-2 and 7-8 around Bottleneck layers 3-6, channels
(16,32,64,128,256,512,512,512), layer counts (1,1,3,4,6,3,1,1), dilation
pairs (2,2) on layer5 and (4,4) on layer6 (the 3x3 conv takes the pair's
second entry), layer7 dilated by 2. Always output stride 8, 512 channels;
the low-level tap is layer3's output, 256 channels at H/4. Keys are the
reference's: ``layer0.{0,1}``, ``layer{1,2,7,8}.{0,1}`` (conv, norm, ReLU
Sequentials) and ``layer{3..6}.{i}`` Bottlenecks.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from uda_clr_tpu_torch.models.layers import Conv2d, run_block, run_layers
from uda_clr_tpu_torch.models.norm import DomainNorm2d
from uda_clr_tpu_torch.models.resnet import bottleneck_stage

CHANNELS = (16, 32, 64, 128, 256, 512, 512, 512)
LAYERS = (1, 1, 3, 4, 6, 3, 1, 1)


def _conv_layers(inplanes: int, channels: int, convs: int, stride: int, dilation: int,
                 norm: str) -> nn.ModuleList:
    mods = []
    for i in range(convs):
        mods += [Conv2d(inplanes, channels, 3, stride if i == 0 else 1, dilation, dilation,
                        bias=False),
                 DomainNorm2d(channels, mode=norm), nn.ReLU()]
        inplanes = channels
    return nn.ModuleList(mods)


class DRN_D_54(nn.Module):
    """Returns (high [B,512,H/8,W/8], low [B,256,H/4,W/4]), NCHW."""

    def __init__(self, norm: str = "bn", remat: bool = False):
        super().__init__()
        ch, n = CHANNELS, LAYERS
        self.remat = remat
        self.layer0 = nn.ModuleList([Conv2d(3, ch[0], 7, 1, 3, bias=False),
                                     DomainNorm2d(ch[0], mode=norm), nn.ReLU()])
        self.layer1 = _conv_layers(ch[0], ch[0], n[0], 1, 1, norm)
        self.layer2 = _conv_layers(ch[0], ch[1], n[1], 2, 1, norm)
        # (in, planes, stride, the 3x3 conv's dilation) of the Bottleneck layers
        for i, (inplanes, planes, stride, dil) in enumerate((
                (ch[1], ch[2], 2, 1), (ch[2] * 4, ch[3], 2, 1),
                (ch[3] * 4, ch[4], 1, 2), (ch[4] * 4, ch[5], 1, 4))):
            setattr(self, f"layer{i + 3}", bottleneck_stage(
                inplanes, planes, n[i + 2], stride, [dil] * n[i + 2], norm))
        self.layer7 = _conv_layers(ch[5] * 4, ch[6], n[6], 1, 2, norm)
        self.layer8 = _conv_layers(ch[6], ch[7], n[7], 1, 1, norm)

    def forward(self, x: torch.Tensor, train: bool, domains: int = 1):
        h = x
        for name in ("layer0", "layer1", "layer2"):
            h = run_layers(getattr(self, name), h, train, domains)
        low = None
        for i in range(3, 7):
            for block in getattr(self, f"layer{i}"):
                h = run_block(block, h, train, domains, self.remat)
            if i == 3:
                low = h
        for name in ("layer7", "layer8"):
            h = run_layers(getattr(self, name), h, train, domains)
        return h, low
