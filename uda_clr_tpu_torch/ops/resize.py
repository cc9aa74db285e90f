"""Resizes (uda_clr_tpu/ops/resize.py), on NCHW tensors."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(bilinear, align_corners=True)``; identity at equal size."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize with source index floor(i * in / out) in integer
    arithmetic (resize.py:79-94); equals ``F.interpolate(mode='nearest')``
    (not ``'nearest-exact'``) on the shapes the step uses."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    rows = torch.arange(h_out, device=x.device) * h_in // h_out
    cols = torch.arange(w_out, device=x.device) * w_in // w_out
    return x.index_select(-2, rows).index_select(-1, cols)
