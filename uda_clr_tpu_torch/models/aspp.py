"""ASPP atrous pyramid (uda_clr_tpu/models/aspp.py), split into ``predrop``
(everything deterministic) and ``drop`` (the final Dropout(0.5)) so the MC
path can replicate at the first dropout site. Keys follow the reference:
``aspp{k}.atrous_conv``/``.bn``, ``global_avg_pool.{1,2}``, ``conv1``,
``bn1``."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from uda_clr_tpu_torch.models.layers import Conv2d, DropoutStream, dropout
from uda_clr_tpu_torch.models.norm import DomainNorm2d, current_rows, global_rows
from uda_clr_tpu_torch.ops.resize import resize_bilinear_align_corners
from uda_clr_tpu_torch.parallel import spatial


class _ASPPBranch(nn.Module):
    def __init__(self, inplanes: int, planes: int, kernel_size: int, dilation: int,
                 norm: str = "bn"):
        super().__init__()
        pad = 0 if kernel_size == 1 else dilation
        self.atrous_conv = Conv2d(inplanes, planes, kernel_size, 1, pad, dilation, bias=False)
        self.bn = DomainNorm2d(planes, mode=norm)

    def forward(self, x, train: bool, domains: int):
        return F.relu(self.bn(self.atrous_conv(x), train, domains))


class ASPP(nn.Module):
    def __init__(self, inplanes: int = 320, output_stride: int = 16, norm: str = "bn"):
        """``inplanes``: the backbone's output width; dilations (1, 6, 12, 18)
        at output stride 16, (1, 12, 24, 36) at 8 (aspp.py:52-57)."""
        super().__init__()
        if output_stride == 16:
            d = (1, 6, 12, 18)
        elif output_stride == 8:
            d = (1, 12, 24, 36)
        else:
            raise NotImplementedError(f"output_stride {output_stride}")
        self.aspp1 = _ASPPBranch(inplanes, 256, 1, d[0], norm)
        self.aspp2 = _ASPPBranch(inplanes, 256, 3, d[1], norm)
        self.aspp3 = _ASPPBranch(inplanes, 256, 3, d[2], norm)
        self.aspp4 = _ASPPBranch(inplanes, 256, 3, d[3], norm)
        self.global_avg_pool = nn.ModuleList([
            nn.AdaptiveAvgPool2d(1), Conv2d(inplanes, 256, 1, bias=False),
            DomainNorm2d(256, mode=norm),
        ])
        self.conv1 = Conv2d(1280, 256, 1, bias=False)
        self.bn1 = DomainNorm2d(256, mode=norm)

    def predrop(self, x: torch.Tensor, train: bool, domains: int = 1) -> torch.Tensor:
        """All of ASPP except the final Dropout(0.5)."""
        branches = [m(x, train, domains) for m in (self.aspp1, self.aspp2, self.aspp3, self.aspp4)]
        if spatial.active():
            branches.append(self._pool_branch_spatial(x, train, domains))
        else:
            pool, conv, bn = self.global_avg_pool
            pooled = F.relu(bn(conv(pool(x)), train, domains))
            branches.append(resize_bilinear_align_corners(pooled, tuple(x.shape[2:])))
        h = self.conv1(torch.cat(branches, dim=1))
        return F.relu(self.bn1(h, train, domains))

    def _pool_branch_spatial(self, x, train: bool, domains: int):
        """The image-pool branch under the spatial mesh: the mean over H and
        W through a sum over the space group, then, in train mode, each
        space rank runs the 1x1 conv and norm on its share of the images
        (of each domain's half where the norm splits the batch) and the
        shares are gathered, so that the norm's batch statistics count
        every image once; the pooled map broadcast over this stripe (the
        align-corners resize of a 1x1 map)."""
        _, conv, bn = self.global_avg_pool
        rows = x.shape[2] * spatial.space_coords()[1]
        pooled = (spatial.space_sum(x.float().sum((2, 3), keepdim=True))
                  / (rows * x.shape[3])).to(x.dtype)
        if not train:
            y = F.relu(bn(conv(pooled), train, domains))
        else:
            groups = 2 if domains == 2 or (bn.mode == "tn" and domains != 0) else 1
            # a one-domain batch's layout (norm.global_rows) follows the rows
            layout = current_rows()
            if layout is not None:
                index = spatial.batch_share(torch.tensor(layout[0]), groups).tolist()
                layout = (index, layout[1])
            with global_rows(layout):
                y = F.relu(bn(conv(spatial.batch_share(pooled, groups)), train, domains))
            y = spatial.gather_batch(y, groups)
        return y.expand(-1, -1, x.shape[2], x.shape[3])

    def drop(self, h, train: bool, stream: DropoutStream | None):
        return dropout(h, 0.5, stream, train)
