"""DeepLabv3+ with the reference's 7-tuple contract (uda_clr_tpu/models/deeplab.py).

``forward`` keeps the JAX package's layout: an NHWC batch in, the 7-tuple
:class:`DeepLabOutputs` out, every field NHWC. Inside, the modules are NCHW;
``features`` / ``heads_prefix`` / ``heads_suffix`` take and give NCHW
tensors (on the card these are ``channels_last``, physically NHWC, so the
NHWC views at the boundary are free).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from uda_clr_tpu_torch.models.aspp import ASPP
from uda_clr_tpu_torch.models.decoder import Decoder
from uda_clr_tpu_torch.models.layers import Conv2d, DropoutStream, init_conv_
from uda_clr_tpu_torch.models.mobilenet import MobileNetV2
from uda_clr_tpu_torch.ops.resize import resize_bilinear_align_corners


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


class DeepLab(nn.Module):
    def __init__(self, num_classes: int = 2, backbone: str = "mobilenet",
                 output_stride: int = 16, seed: int = 0, norm: str = "bn"):
        super().__init__()
        if backbone != "mobilenet":
            raise NotImplementedError(f"backbone {backbone!r} is not ported yet")
        self.norm = norm  # 'bn' | 'tn' (TransNorm) at every norm site
        self.backbone = MobileNetV2(output_stride, norm)
        self.aspp = ASPP(320, output_stride, norm)
        self.decoder = Decoder(num_classes, 24, norm)
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, Conv2d):
                init_conv_(m, g)

    def features(self, x, train: bool = False, domains: int = 1):
        """Backbone only (no dropout in it)."""
        return self.backbone(x, train, domains)

    def heads_prefix(self, high, low, train: bool = False, domains: int = 1):
        """ASPP minus its final dropout, plus the low-level projection."""
        return self.aspp.predrop(high, train, domains), self.decoder.low_prefix(low, train, domains)

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

    def forward(self, x_nhwc: torch.Tensor, train: bool = False, domains: int = 1,
                stream: DropoutStream | None = None) -> DeepLabOutputs:
        x = nchw(x_nhwc)
        high, low = self.features(x, train, domains)
        fp, ll = self.heads_prefix(high, low, train, domains)
        return self.heads_suffix(fp, ll, tuple(x.shape[2:]), train, domains, stream)
