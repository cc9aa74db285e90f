"""Modified Aligned Xception backbone (uda_clr_tpu/models/xception.py
:19-158): an entry flow (a conv stem and three strided blocks), a middle
flow of 16 blocks at 728 channels, and an exit flow (a block and three
dilated separable convs to 2048 channels). Separable convs pre-pad with
``fixed_padding`` and hold a norm between the depthwise and the pointwise
conv. The low-level tap is relu(block1), 128 channels at H/4.

Keys are the reference's: a block's ``rep`` Sequential of (ReLU,
SeparableConv2d, norm) units, less the first ReLU without
``start_with_relu``, and its ``skip``/``skipbn`` projection;
:func:`xception_rep_indices` replays that construction for the weight
bridge.

While the profiler records, the forward is cut into the consecutive
phases ``clr.backbone.entry`` (stem and blocks 1-3), ``clr.backbone.middle``
(blocks 4-19) and ``clr.backbone.exit`` (block 20 and conv3-5) of the
``clr.backbone`` span that ``DeepLab.features`` opens (utils/tracing.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from uda_clr_tpu_torch.models.layers import Conv2d, fixed_padding, run_block
from uda_clr_tpu_torch.models.norm import DomainNorm2d
from uda_clr_tpu_torch.utils import tracing


def xception_block_plan(output_stride: int = 16) -> dict:
    """{block number: (in, out, reps, stride, dilation, start_with_relu,
    grow_first, is_last)} of blocks 1-20 (xception.py:129-145)."""
    if output_stride == 16:
        entry3_stride, mid_dil, exit_dil = 2, 1, 1
    elif output_stride == 8:
        entry3_stride, mid_dil, exit_dil = 1, 2, 2
    else:
        raise NotImplementedError(f"output_stride {output_stride}")
    plan = {1: (64, 128, 2, 2, 1, False, True, False),
            2: (128, 256, 2, 2, 1, False, True, False),
            3: (256, 728, 2, entry3_stride, 1, True, True, True)}
    for i in range(4, 20):
        plan[i] = (728, 728, 3, 1, mid_dil, True, True, False)
    plan[20] = (728, 1024, 2, 1, exit_dil, True, False, True)
    return plan


def _units(inplanes, planes, reps, stride, dilation, grow_first, is_last):
    """(in, out, stride, dilation) of a block's separable convs, in order."""
    units = [(inplanes, planes, 1, dilation)] if grow_first else []
    filters = planes if grow_first else inplanes
    units += [(filters, filters, 1, dilation)] * (reps - 1)
    if not grow_first:
        units.append((inplanes, planes, 1, dilation))
    if stride != 1:
        units.append((planes, planes, 2, 1))
    elif is_last:
        units.append((planes, planes, 1, 1))
    return units


def xception_rep_indices(inplanes, planes, reps, stride, dilation, start_with_relu,
                         grow_first, is_last) -> list[int]:
    """The ``rep`` index of each separable conv of a block (its norm sits
    at the next index): three entries per unit, the first ReLU dropped
    without ``start_with_relu``."""
    n = len(_units(inplanes, planes, reps, stride, dilation, grow_first, is_last))
    return [3 * k + (1 if start_with_relu else 0) for k in range(n)]


class SeparableConv2d(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 norm: str = "bn"):
        super().__init__()
        self.dilation = dilation
        self.conv1 = Conv2d(inplanes, inplanes, 3, stride, 0, dilation, groups=inplanes,
                            bias=False)
        self.bn = DomainNorm2d(inplanes, mode=norm)
        self.pointwise = Conv2d(inplanes, planes, 1, bias=False)

    def forward(self, x: torch.Tensor, train: bool, domains: int = 1) -> torch.Tensor:
        h = self.conv1(fixed_padding(x, 3, self.dilation))
        return self.pointwise(self.bn(h, train, domains))


class Block(nn.Module):
    def __init__(self, inplanes, planes, reps, stride=1, dilation=1, start_with_relu=True,
                 grow_first=True, is_last=False, norm: str = "bn"):
        super().__init__()
        if planes != inplanes or stride != 1:
            self.skip = Conv2d(inplanes, planes, 1, stride, bias=False)
            self.skipbn = DomainNorm2d(planes, mode=norm)
        else:
            self.skip = None
        rep = []
        for cin, cout, s, d in _units(inplanes, planes, reps, stride, dilation, grow_first,
                                      is_last):
            rep += [nn.ReLU(), SeparableConv2d(cin, cout, s, d, norm),
                    DomainNorm2d(cout, mode=norm)]
        self.rep = nn.ModuleList(rep if start_with_relu else rep[1:])

    def forward(self, x: torch.Tensor, train: bool, domains: int = 1) -> torch.Tensor:
        h = x
        for m in self.rep:
            h = m(h) if isinstance(m, nn.ReLU) else m(h, train, domains)
        skip = x if self.skip is None else self.skipbn(self.skip(x), train, domains)
        return h + skip


class AlignedXception(nn.Module):
    """Returns (high [B,2048,H/os,W/os], low [B,128,H/4,W/4]), NCHW."""

    def __init__(self, output_stride: int = 16, norm: str = "bn", remat: bool = False):
        super().__init__()
        plan = xception_block_plan(output_stride)
        dil = 2 if output_stride == 16 else 4  # the exit flow's separable convs
        self.remat = remat
        self.conv1 = Conv2d(3, 32, 3, 2, 1, bias=False)
        self.bn1 = DomainNorm2d(32, mode=norm)
        self.conv2 = Conv2d(32, 64, 3, 1, 1, bias=False)
        self.bn2 = DomainNorm2d(64, mode=norm)
        for i, cfg in plan.items():
            setattr(self, f"block{i}", Block(*cfg, norm=norm))
        for i, (cin, cout) in zip((3, 4, 5), ((1024, 1536), (1536, 1536), (1536, 2048))):
            setattr(self, f"conv{i}", SeparableConv2d(cin, cout, 1, dil, norm))
            setattr(self, f"bn{i}", DomainNorm2d(cout, mode=norm))

    def forward(self, x: torch.Tensor, train: bool, domains: int = 1):
        tracing.phase("clr.backbone.entry")
        h = F.relu(self.bn1(self.conv1(x), train, domains))
        h = F.relu(self.bn2(self.conv2(h), train, domains))
        low = None
        for i in range(1, 21):
            if i in (4, 20):
                tracing.phase("clr.backbone.middle" if i == 4 else "clr.backbone.exit")
            h = run_block(getattr(self, f"block{i}"), h, train, domains, self.remat)
            if i == 1:
                h = low = F.relu(h)
        h = F.relu(h)
        for i in (3, 4, 5):
            h = getattr(self, f"conv{i}")(h, train, domains)
            h = F.relu(getattr(self, f"bn{i}")(h, train, domains))
        return h, low
