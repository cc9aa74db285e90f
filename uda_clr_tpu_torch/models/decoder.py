"""Dual-head (mask + boundary) DeepLab decoder (uda_clr_tpu/models/decoder.py),
split into ``low_prefix`` / ``suffix_bound`` / ``suffix``. Keys follow the
reference: ``conv1``, ``bn1``, ``last_conv.{0,3}`` (mask head: BN(305),
ReLU, Dropout(0.1), 1x1) and ``last_conv_boundary.{0,1,4,5,8}``."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from uda_clr_tpu_torch.models.layers import Conv2d, Dropout, run_layers
from uda_clr_tpu_torch.models.norm import DomainNorm2d
from uda_clr_tpu_torch.ops.resize import resize_bilinear_align_corners


class Decoder(nn.Module):
    def __init__(self, num_classes: int = 2, low_level_inplanes: int = 24, norm: str = "bn"):
        super().__init__()
        self.conv1 = Conv2d(low_level_inplanes, 48, 1, bias=False)
        self.bn1 = DomainNorm2d(48, mode=norm)
        self.last_conv = nn.ModuleList([
            DomainNorm2d(305, mode=norm), nn.ReLU(), Dropout(0.1), Conv2d(305, num_classes, 1),
        ])
        self.last_conv_boundary = nn.ModuleList([
            Conv2d(304, 256, 3, 1, 1, bias=False), DomainNorm2d(256, mode=norm), nn.ReLU(),
            Dropout(0.5),
            Conv2d(256, 256, 3, 1, 1, bias=False), DomainNorm2d(256, mode=norm), nn.ReLU(),
            Dropout(0.1),
            Conv2d(256, 1, 1),
        ])

    def low_prefix(self, low, train: bool, domains: int = 1):
        """Deterministic low-level projection (conv1 + bn1 + relu)."""
        return F.relu(self.bn1(self.conv1(low), train, domains))

    def suffix_bound(self, x, ll, train: bool, domains: int, stream):
        """Upsample + concat + the boundary head."""
        x = resize_bilinear_align_corners(x, tuple(ll.shape[2:]))
        x_bu = torch.cat([x, ll], dim=1)  # [B, 304, h, w]
        boundary = run_layers(self.last_conv_boundary, x_bu, train, domains, stream)
        return x_bu, boundary

    def suffix(self, x, ll, train: bool, domains: int, stream):
        """Upsample + boundary head + mask head (all the dropout sites)."""
        x_bu, boundary = self.suffix_bound(x, ll, train, domains, stream)
        x_feature = torch.cat([x_bu, boundary], dim=1)  # [B, 305, h, w]
        x1 = run_layers(self.last_conv, x_feature, train, domains, stream)
        return x1, boundary, x_bu, x_feature
