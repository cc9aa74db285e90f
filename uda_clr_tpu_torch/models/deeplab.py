"""DeepLabv3+ with the reference's 7-tuple contract (uda_clr_tpu/models/deeplab.py)
on the four backbones: MobileNetV2, ResNet-101, Aligned Xception and
DRN-D-54 (which always runs at output stride 8, deeplab.py:84).

``forward`` keeps the JAX package's layout: an NHWC batch in, the 7-tuple
:class:`DeepLabOutputs` out, every field NHWC. Inside, the modules are NCHW;
``features`` / ``heads_prefix`` / ``heads_suffix`` take and give NCHW
tensors (on the card these are ``channels_last``, physically NHWC, so the
NHWC views at the boundary are free). :class:`Heads` is the classifier half
alone (ASPP + decoder, keys ``aspp.*``, ``decoder.*``): DeepLab extends it
with a backbone, and the ``bcdm`` method's second classifier is one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from uda_clr_tpu_torch.models.aspp import ASPP
from uda_clr_tpu_torch.models.decoder import Decoder
from uda_clr_tpu_torch.models.drn import DRN_D_54
from uda_clr_tpu_torch.models.layers import Conv2d, DropoutStream, init_conv_
from uda_clr_tpu_torch.models.mobilenet import MobileNetV2
from uda_clr_tpu_torch.models.resnet import ResNet101
from uda_clr_tpu_torch.models.xception import AlignedXception
from uda_clr_tpu_torch.ops.resize import resize_bilinear_align_corners
from uda_clr_tpu_torch.utils import tracing

# the backbone's (high-level, low-level) output widths: ASPP's input and the
# decoder's low-level input (deeplab.py:37)
BACKBONE_WIDTHS = {"mobilenet": (320, 24), "resnet": (2048, 256), "xception": (2048, 128),
                   "drn": (512, 256)}


def effective_output_stride(backbone: str, output_stride: int) -> int:
    """DRN runs at output stride 8 whatever is asked (deeplab.py:84)."""
    return 8 if backbone == "drn" else output_stride


def build_backbone(backbone: str, output_stride: int, norm: str, remat: bool) -> nn.Module:
    if backbone == "mobilenet":
        return MobileNetV2(output_stride, norm, remat)
    if backbone == "resnet":
        return ResNet101(output_stride, norm, remat)
    if backbone == "xception":
        return AlignedXception(output_stride, norm, remat)
    if backbone == "drn":
        return DRN_D_54(norm, remat)
    raise NotImplementedError(f"backbone {backbone!r}")


def _init_convs(module: nn.Module, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, Conv2d):
            init_conv_(m, g)


class DeepLabOutputs(NamedTuple):
    mask_logits: torch.Tensor  # [B, H, W, num_classes]
    boundary_logits: torch.Tensor  # [B, H, W, 1]
    aspp_feature: torch.Tensor  # [B, H/os, W/os, 256]
    x_bu_feature: torch.Tensor  # [B, H/4, W/4, 304]
    x_feature: torch.Tensor  # [B, H/4, W/4, 305]
    mask_before: torch.Tensor  # [B, H/4, W/4, num_classes]
    boundary_before: torch.Tensor  # [B, H/4, W/4, 1]


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class Heads(nn.Module):
    """ASPP + dual-head decoder for ``backbone``'s widths, seeded alone."""

    def __init__(self, num_classes: int = 2, backbone: str = "mobilenet",
                 output_stride: int = 16, seed: int = 0, norm: str = "bn"):
        super().__init__()
        self._build_heads(num_classes, backbone, output_stride, norm)
        _init_convs(self, seed)

    def _build_heads(self, num_classes, backbone, output_stride, norm):
        if backbone not in BACKBONE_WIDTHS:
            raise NotImplementedError(f"backbone {backbone!r}")
        high, low = BACKBONE_WIDTHS[backbone]
        self.norm = norm  # 'bn' | 'tn' (TransNorm) at every norm site
        self.output_stride = effective_output_stride(backbone, output_stride)
        self.aspp = ASPP(high, self.output_stride, norm)
        self.decoder = Decoder(num_classes, low, norm)

    def heads_prefix(self, high, low, train: bool = False, domains: int = 1):
        """ASPP minus its final dropout, plus the low-level projection."""
        return self.aspp.predrop(high, train, domains), self.decoder.low_prefix(low, train, domains)

    def prefix_parameters(self) -> list:
        """The parameters :meth:`heads_prefix` reads."""
        dec = self.decoder
        return [*self.aspp.parameters(), *dec.conv1.parameters(), *dec.bn1.parameters()]

    def heads_suffix(self, feat_predrop, ll, out_hw, train: bool = False,
                     domains: int = 1, stream: DropoutStream | None = None):
        """ASPP dropout + decoder heads + align-corners upsample to ``out_hw``.
        Without a ``stream`` the dropout sites draw from torch's default
        generator and a K3 seed from it (host side)."""
        if stream is None and train:
            stream = DropoutStream(None, int(torch.randint(2**62, ())))
        feat = self.aspp.drop(feat_predrop, train, stream)
        x1, boundary, x_bu, x_feature = self.decoder.suffix(feat, ll, train, domains, stream)
        mask_logits = resize_bilinear_align_corners(x1, out_hw)
        boundary_logits = resize_bilinear_align_corners(boundary, out_hw)
        return DeepLabOutputs(*(nhwc(t) for t in (
            mask_logits, boundary_logits, feat, x_bu, x_feature, x1, boundary)))

    def heads(self, high, low, out_hw, train: bool = False, domains: int = 1,
              stream: DropoutStream | None = None) -> DeepLabOutputs:
        """ASPP + decoder heads + upsample, from the backbone's outputs."""
        fp, ll = self.heads_prefix(high, low, train, domains)
        return self.heads_suffix(fp, ll, out_hw, train, domains, stream)


class DeepLab(Heads):
    """Backbone + heads. ``remat``: every backbone block rematerialised in
    train-mode forwards that record gradients (layers.run_block)."""

    def __init__(self, num_classes: int = 2, backbone: str = "mobilenet",
                 output_stride: int = 16, seed: int = 0, norm: str = "bn",
                 remat: bool = False):
        nn.Module.__init__(self)
        self.backbone = build_backbone(backbone, effective_output_stride(backbone, output_stride),
                                       norm, remat)
        self._build_heads(num_classes, backbone, output_stride, norm)
        _init_convs(self, seed)

    def features(self, x, train: bool = False, domains: int = 1):
        """Backbone only (no dropout in it), inside the span ``clr.backbone``
        (utils/tracing.py: recorded only while the profiler records)."""
        with tracing.span("clr.backbone"):
            return self.backbone(x, train, domains)

    def forward(self, x_nhwc: torch.Tensor, train: bool = False, domains: int = 1,
                stream: DropoutStream | None = None) -> DeepLabOutputs:
        x = nchw(x_nhwc)
        high, low = self.features(x, train, domains)
        return self.heads(high, low, tuple(x.shape[2:]), train, domains, stream)
