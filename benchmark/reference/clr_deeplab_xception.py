"""Plain reference of the CLR train step on DeepLabv3+'s Modified Aligned
Xception-65 backbone at output stride 16: :mod:`clr_deeplab`'s model,
step, heads, PatchGANs, losses, MC pass and optimizers, imported, on a
plain Xception written here and entered in its table of backbones, in
float32 with no hand-written kernels. It imports nothing of the program.

The backbone (Chen et al., *Encoder-Decoder with Atrous Separable
Convolution*, arXiv:1802.02611, §3.2 and Fig. 4), in the layout of the
CLR reference's ``networks/backbone/xception.py`` (github.com/fengweie/
UDA_CLR, reached through ``build_backbone('xception')``), whose state-dict
keys the program keeps:

* entry flow: ``conv1`` 3x3/2 to 32 and ``conv2`` 3x3 to 64, each with its
  norm and a ReLU; blocks 1-3 (64 -> 128 -> 256 -> 728), each ending in a
  stride-2 separable conv; relu(block 1), 128 channels at H/4, is the
  decoder's low-level input;
* middle flow: blocks 4-19, three separable convs at 728 channels each,
  with an identity shortcut;
* exit flow: block 20 (728 -> 1024, the widening conv last), a ReLU, then
  ``conv3``-``conv5`` (1024 -> 1536 -> 1536 -> 2048), each a separable conv
  at dilation 2 with its norm and a ReLU.

A block's ``rep`` holds (ReLU, separable conv, norm) units, less the first
ReLU where the block does not start with one (blocks 1 and 2); its
shortcut is ``skip`` (1x1, the block's stride) and ``skipbn`` where the
width or the stride changes. A separable conv pads its input for a 'same'
output under its dilation (``fixed_padding``), runs the depthwise 3x3
conv, its norm (``bn``) and the pointwise 1x1 conv.

Departures from the paper, each as the CLR reference (and so the program)
has it:

* each of the paper's max-pools is a stride-2 separable conv (as the paper
  itself proposes), and a block ends with an extra stride-1 separable conv
  where it is the last of its flow (blocks 3 and 20);
* the paper adds a batch norm and a ReLU after each depthwise conv; here a
  norm sits between the depthwise and the pointwise conv with no ReLU, and
  another after each separable conv; the shortcut adds to the last norm's
  output, with no ReLU after the sum;
* the stride-2 and the closing stride-1 convs of a block run at dilation 1
  whatever the block's dilation;
* a block's shortcut takes the block's input as it came in, before the
  ReLU that opens ``rep``;
* the norm is batch norm with per-half source || target moments
  (:class:`clr_deeplab.BatchNorm`), not a synchronised one.

``quant`` (the lower-precision control) rounds as :mod:`clr_deeplab`
describes, here also the separable convs' inputs, weights and outputs and
each block's residual sum.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from . import clr_deeplab as base
from .clr_deeplab import BatchNorm, Conv2d, Module

build, optimizers, train_step = base.build, base.optimizers, base.train_step


def fixed_padding(x, dilation: int):
    """Zero padding for a 'same' 3x3 output at ``dilation``: ``dilation``
    pixels on each side."""
    return F.pad(x, (dilation, dilation, dilation, dilation))


class SeparableConv2d(Module):
    """Depthwise 3x3 (stride, dilation), its norm, pointwise 1x1."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.conv1 = Conv2d(inplanes, inplanes, 3, stride, 0, dilation, groups=inplanes,
                            bias=False)
        self.bn = BatchNorm(inplanes)
        self.pointwise = Conv2d(inplanes, planes, 1, bias=False)

    def forward(self, x, domains):
        return self.pointwise(self.bn(self.conv1(fixed_padding(x, self.dilation)), domains))


class Block(Module):
    def __init__(self, inplanes, planes, reps, stride=1, dilation=1, start_with_relu=True,
                 grow_first=True, is_last=False):
        super().__init__()
        if planes != inplanes or stride != 1:
            self.skip = Conv2d(inplanes, planes, 1, stride, bias=False)
            self.skipbn = BatchNorm(planes)
        else:
            self.skip = None
        convs = []  # (in, out, stride, dilation) of the separable convs
        filters = inplanes
        if grow_first:
            convs.append((inplanes, planes, 1, dilation))
            filters = planes
        convs += [(filters, filters, 1, dilation)] * (reps - 1)
        if not grow_first:
            convs.append((inplanes, planes, 1, dilation))
        if stride != 1:
            convs.append((planes, planes, 2, 1))
        elif is_last:
            convs.append((planes, planes, 1, 1))
        rep = []
        for cin, cout, s, d in convs:
            rep += [nn.ReLU(), SeparableConv2d(cin, cout, s, d), BatchNorm(cout)]
        self.rep = nn.ModuleList(rep if start_with_relu else rep[1:])

    def forward(self, x, domains):
        h = x
        for m in self.rep:
            h = F.relu(h) if isinstance(m, nn.ReLU) else m(h, domains)
        skip = x if self.skip is None else self.skipbn(self.skip(x), domains)
        return self.q(h + skip)


class AlignedXception(Module):
    """(high [B,2048,H/16,W/16], low = relu(block1) [B,128,H/4,W/4])."""
    widths = (2048, 128)

    def __init__(self, output_stride: int = 16):
        super().__init__()
        if output_stride != 16:
            raise NotImplementedError("the reference holds output stride 16")
        self.conv1 = Conv2d(3, 32, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm(32)
        self.conv2 = Conv2d(32, 64, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(64)
        # entry flow
        self.block1 = Block(64, 128, 2, 2, start_with_relu=False)
        self.block2 = Block(128, 256, 2, 2, start_with_relu=False)
        self.block3 = Block(256, 728, 2, 2, is_last=True)
        # middle flow
        for i in range(4, 20):
            setattr(self, f"block{i}", Block(728, 728, 3))
        # exit flow
        self.block20 = Block(728, 1024, 2, 1, 1, grow_first=False, is_last=True)
        for i, (cin, cout) in zip((3, 4, 5), ((1024, 1536), (1536, 1536), (1536, 2048))):
            setattr(self, f"conv{i}", SeparableConv2d(cin, cout, 1, 2))
            setattr(self, f"bn{i}", BatchNorm(cout))

    def forward(self, x, domains):
        h = F.relu(self.bn1(self.conv1(x), domains))
        h = F.relu(self.bn2(self.conv2(h), domains))
        low = h = F.relu(self.block1(h, domains))
        for i in range(2, 21):
            h = getattr(self, f"block{i}")(h, domains)
        h = F.relu(h)
        for i in (3, 4, 5):
            h = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h, domains), domains))
        return h, low


# clr_deeplab's DeepLab builds its backbone from this table: the generator
# on Xception is its DeepLab("xception"), and build() its build()
base.BACKBONES["xception"] = AlignedXception
