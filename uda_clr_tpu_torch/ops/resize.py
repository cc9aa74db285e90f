"""Resizes (uda_clr_tpu/ops/resize.py), on NCHW tensors. Under the spatial
mesh (parallel/spatial.py) both take and give this rank's stripe: the
sizes they see are the stripe's, the whole image's H being n_space times
as many rows."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from uda_clr_tpu_torch.parallel import spatial


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(bilinear, align_corners=True)``; identity at equal size."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    if spatial.active():
        return _bilinear_stripe(x, tuple(out_hw))
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)


def _bilinear_stripe(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """This stripe's rows of the align-corners resize of the whole image:
    output row y reads input rows i0 = floor(y (H_in-1)/(H_out-1)) and the
    next, global rows that may lie in other stripes (fetched as halo rows),
    with PyTorch's source positions; the columns resize with
    ``F.interpolate`` (an identity on the rows). Computed in float32
    (float64 for float64 input), as PyTorch's kernels accumulate."""
    s, n = spatial.space_coords()
    h_in, h_out = x.shape[2], out_hw[0]
    rows_in, rows_out = h_in * n, h_out * n
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32  # PyTorch's opmath
    f = np.float64 if acc == torch.float64 else np.float32
    scale = f(rows_in - 1) / f(rows_out - 1) if rows_out > 1 else f(0)
    real = f(scale) * np.arange(rows_out, dtype=f)
    i0 = real.astype(np.int64)
    lam = np.clip(real - i0.astype(f), 0, 1).astype(f)
    i1 = i0 + (i0 < rows_in - 1)
    # every stripe asks for the same halo: the widest any stripe needs
    firsts = np.arange(n) * h_in
    top = max(0, int((firsts - i0[::h_out]).max()))
    bottom = max(0, int((i1[h_out - 1::h_out] - (firsts + h_in - 1)).max()))
    mine = slice(s * h_out, (s + 1) * h_out)
    i0, i1, lam, first = i0[mine], i1[mine], lam[mine], s * h_in
    xh = spatial.halo_rows(x.to(acc), top, bottom)
    if xh.shape[3] != out_hw[1]:
        xh = F.interpolate(xh, size=(xh.shape[2], out_hw[1]), mode="bilinear",
                           align_corners=True)
    base = first - top
    dev = x.device
    r0 = xh.index_select(2, torch.from_numpy(i0 - base).to(dev))
    r1 = xh.index_select(2, torch.from_numpy(i1 - base).to(dev))
    lam_t = torch.from_numpy(lam).to(dev).reshape(1, 1, -1, 1)
    return (r0 * (1.0 - lam_t) + r1 * lam_t).to(x.dtype)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize with source index floor(i * in / out) in integer
    arithmetic (resize.py:79-94); equals ``F.interpolate(mode='nearest')``
    (not ``'nearest-exact'``) on the shapes the step uses. Under the
    spatial mesh the rows stay in their stripe only when one size divides
    the other: asserted."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    if spatial.active() and h_in % h_out and h_out % h_in:
        raise ValueError(f"a nearest resize of a stripe from {h_in} to {h_out} rows reads "
                         f"across stripes; under the spatial mesh one size must divide the other")
    rows = torch.arange(h_out, device=x.device) * h_in // h_out
    cols = torch.arange(w_out, device=x.device) * w_in // w_out
    return x.index_select(-2, rows).index_select(-1, cols)
