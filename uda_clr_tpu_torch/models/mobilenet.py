"""MobileNetV2 backbone with its atrous plan at output stride 16 or 8
(uda_clr_tpu/models/mobilenet.py:36-126). Keys follow the reference:
``features.0.{0,1}`` is the stem, ``features.{i+1}.conv.{k}`` block i."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from uda_clr_tpu_torch.models.layers import (
    Conv2d,
    fixed_padding,
    fixed_pads,
    run_block,
    run_layers,
)
from uda_clr_tpu_torch.models.norm import DomainNorm2d
from uda_clr_tpu_torch.parallel import spatial

# (expand_ratio t, channels c, repeats n, stride s)
_INVERTED_RESIDUAL_SETTINGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def mobilenet_block_plan(output_stride: int = 16):
    """Per-block (in, out, stride, dilation, t); ``dilation = rate`` is read
    before ``rate *= s``, as in the reference (mobilenet.py:67-89)."""
    plan = []
    in_ch = 32
    current_stride = 2
    rate = 1
    for t, c, n, s in _INVERTED_RESIDUAL_SETTINGS:
        if current_stride == output_stride:
            stride, dilation = 1, rate
            rate *= s
        else:
            stride, dilation = s, 1
            current_stride *= s
        for i in range(n):
            plan.append((in_ch, c, stride if i == 0 else 1, dilation, t))
            in_ch = c
    return plan


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int, dilation: int, t: int,
                 norm: str = "bn"):
        super().__init__()
        hidden = round(inp * t)
        self.dilation = dilation
        self.n_expand = 0 if t == 1 else 3  # the pointwise layers before the depthwise conv
        self.use_res = stride == 1 and inp == oup
        dw = Conv2d(hidden, hidden, 3, stride, 0, dilation, groups=hidden, bias=False)
        layers = [] if t == 1 else [
            Conv2d(inp, hidden, 1, 1, 0, bias=False), DomainNorm2d(hidden, mode=norm), nn.ReLU6(),
        ]
        layers += [dw, DomainNorm2d(hidden, mode=norm), nn.ReLU6(),
                   Conv2d(hidden, oup, 1, 1, 0, bias=False), DomainNorm2d(oup, mode=norm)]
        self.conv = nn.ModuleList(layers)

    def forward(self, x, train: bool, domains: int = 1):
        if not spatial.active():
            h = run_layers(self.conv, fixed_padding(x, 3, self.dilation), train, domains)
        else:
            # the expansion is pointwise: it runs on this stripe padded at the
            # image's edges only, so its norm counts every padded row once
            # (the stripes are then uneven: the norm takes the all-summed
            # count), then the depthwise conv's halo rows come from the
            # neighbouring stripes
            beg, end = fixed_pads(3, self.dilation)
            h = spatial.edge_pad(F.pad(x, (beg, end, 0, 0)), beg, end)
            h = run_layers(self.conv[:self.n_expand], h, train, domains)
            h = spatial.halo_rows(h, beg, end, edge=(beg, end))
            h = run_layers(self.conv[self.n_expand:], h, train, domains)
        return x + h if self.use_res else h


class MobileNetV2(nn.Module):
    """Returns (high [B,320,H/os,W/os], low [B,24,H/4,W/4]), NCHW."""

    def __init__(self, output_stride: int = 16, norm: str = "bn", remat: bool = False):
        super().__init__()
        self.remat = remat  # every inverted-residual block rematerialised (run_block)
        stem = nn.ModuleList([Conv2d(3, 32, 3, 2, 1, bias=False), DomainNorm2d(32, mode=norm),
                              nn.ReLU6()])
        blocks = [InvertedResidual(*p, norm=norm) for p in mobilenet_block_plan(output_stride)]
        self.features = nn.ModuleList([stem] + blocks)

    def forward(self, x: torch.Tensor, train: bool, domains: int = 1):
        h = run_layers(self.features[0], x, train, domains)
        low = None
        for idx, block in enumerate(self.features[1:]):
            h = run_block(block, h, train, domains, self.remat)
            if idx == 2:  # torch features[0:4] = stem + blocks 0-2
                low = h
        return h, low
