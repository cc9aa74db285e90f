"""ResNet-101 backbone with the multi-grid atrous last stage
(uda_clr_tpu/models/resnet.py:23-94): Bottleneck stages [3, 4, 23, 3],
strides (1,2,2,1) and dilations (1,1,1,2) at output stride 16, (1,2,1,1)
and (1,1,2,4) at 8, multi-grid rates [1,2,4] on layer4; the low-level tap
is layer1's output, 256 channels at H/4. Keys are torchvision's, as the
reference's (``conv1``, ``bn1``, ``layer{L}.{i}.conv{k}``/``.bn{k}``,
``.downsample.{0,1}``), so the ImageNet resnet101 file loads directly.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from uda_clr_tpu_torch.models.layers import Conv2d, max_pool_3x3_s2, run_block, run_layers
from uda_clr_tpu_torch.models.norm import DomainNorm2d

# (planes, blocks) of layer1-4
_STAGES = ((64, 3), (128, 4), (256, 23), (512, 3))
MULTI_GRID = (1, 2, 4)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 x4, with a strided 1x1 + norm
    projection when the shape changes (resnet.py:23-53; DRN's is the same,
    drn.py:19-47)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, norm: str = "bn"):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = DomainNorm2d(planes, mode=norm)
        self.conv2 = Conv2d(planes, planes, 3, stride, dilation, dilation, bias=False)
        self.bn2 = DomainNorm2d(planes, mode=norm)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = DomainNorm2d(planes * 4, mode=norm)
        self.downsample = nn.ModuleList([
            Conv2d(inplanes, planes * 4, 1, stride, bias=False),
            DomainNorm2d(planes * 4, mode=norm),
        ]) if downsample else None

    def forward(self, x: torch.Tensor, train: bool, domains: int = 1) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x), train, domains))
        h = F.relu(self.bn2(self.conv2(h), train, domains))
        h = self.bn3(self.conv3(h), train, domains)
        res = x if self.downsample is None else run_layers(self.downsample, x, train, domains)
        return F.relu(h + res)


def bottleneck_stage(inplanes: int, planes: int, blocks: int, stride: int, dilations,
                     norm: str) -> nn.ModuleList:
    """``blocks`` Bottlenecks, the first strided (and projected where the
    stride or width changes), block i at dilation ``dilations[i]``."""
    layer = []
    for i in range(blocks):
        down = i == 0 and (stride != 1 or inplanes != planes * 4)
        layer.append(Bottleneck(inplanes, planes, stride if i == 0 else 1, dilations[i],
                                down, norm))
        inplanes = planes * 4
    return nn.ModuleList(layer)


class ResNet101(nn.Module):
    """Returns (high [B,2048,H/os,W/os], low [B,256,H/4,W/4]), NCHW."""

    def __init__(self, output_stride: int = 16, norm: str = "bn", remat: bool = False):
        super().__init__()
        if output_stride == 16:
            strides, dilations = (1, 2, 2, 1), (1, 1, 1, 2)
        elif output_stride == 8:
            strides, dilations = (1, 2, 1, 1), (1, 1, 2, 4)
        else:
            raise NotImplementedError(f"output_stride {output_stride}")
        self.remat = remat
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = DomainNorm2d(64, mode=norm)
        inplanes = 64
        for i, (planes, blocks) in enumerate(_STAGES):
            rates = MULTI_GRID if i == 3 else (1,) * blocks
            setattr(self, f"layer{i + 1}", bottleneck_stage(
                inplanes, planes, blocks, strides[i], [r * dilations[i] for r in rates], norm))
            inplanes = planes * 4

    def forward(self, x: torch.Tensor, train: bool, domains: int = 1):
        h = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x), train, domains)))
        low = None
        for i in range(1, 5):
            for block in getattr(self, f"layer{i}"):
                h = run_block(block, h, train, domains, self.remat)
            if i == 1:
                low = h
        return h, low
