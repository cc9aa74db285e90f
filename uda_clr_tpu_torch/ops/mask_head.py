"""Fused MC mask-head epilogue: BN apply (batch moments given) + ReLU +
dropout + 1x1 conv 305 -> 2, two entry points over the same row code:

* :func:`fused_mask_head_split` (K1) takes three row views x_up[256] |
  ll[48] | boundary[1] whose 305-channel concat never exists; it replaces
  the TPU kernel ``uda_clr_tpu/ops/pallas/mask_head.py:_kernel_split``
  (entry ``fused_mask_head_split``) and runs in the MC pass;
* :func:`fused_mask_head` (K2) takes x_bu[304] | boundary[1]; it replaces
  ``mask_head.py:_kernel`` (entry ``fused_mask_head``), which no path of
  the JAX package calls.

On a CUDA tensor each wrapper launches its entry of the hand-written
kernel ``csrc/mask_head.cu`` or raises; there is no fallback. On a CPU
tensor it runs :func:`mask_head_plain`, the plain PyTorch version with the
same rounding points (kept elements scale by 1/keep rounded to the input
dtype, as the TPU kernel does) and the same Philox4x32-10 dropout stream,
so the two agree elementwise at any rate.

The kernel's least time is set by bytes: it reads each input once (~644 MB
at the flagship shape in bf16, 0.19 ms on an H100; f32 0.38 ms) and writes
[M, 2]. Next comes the integer work of the draws, 80 M Philox evaluations
at that shape (~0.1-0.2 ms by instruction count; their wide multiplies
make it ~0.32 ms measured, which is what holds the bf16 kernel at ~0.40
ms). The kernel walks row tiles that start on a Philox group: draw warps
evaluate each group once into a shared-memory keep mask while bulk copies
stage the tiles ahead and compute warps work in packed bf16 (see the
source; PERF.md for its times). Every input view must be 16-byte aligned,
``boundary`` included.
Built with ``nvcc`` for sm_90a into ``build/kernels/`` at first use and
bound through plain C entry points with ctypes (ops/cuda_build.py).
"""

from __future__ import annotations

import torch

from uda_clr_tpu_torch.ops import cuda_build
from uda_clr_tpu_torch.ops.cuda_build import F32, I64, INT, P, U32, U64
from uda_clr_tpu_torch.ops.philox import (  # noqa: F401  (re-exported for callers)
    MASK32,
    inv_keep,
    keep_threshold,
    philox4x32_10,
    philox_words,
)

C_X, C_L, C_ALL = 256, 48, 305

SIGNATURES = {
    "uda_mask_head_split": [P] * 5 + [I64, U64, U32, F32, INT, INT, INT, P],
    "uda_mask_head": [P] * 4 + [I64, U64, U32, F32, INT, INT, INT, P],
}
LIBRARY = cuda_build.KernelLibrary("mask_head.cu", {
    **SIGNATURES, "uda_mask_head_occupancy": [INT, INT, INT, INT, P, P]})

# Launches of each CUDA entry; a run can show the main path went through it.
LAUNCHES = 0  # K1, fused_mask_head_split
LAUNCHES_BU = 0  # K2, fused_mask_head
# Rows through K1 and K2's CUDA launches: their 305 -> 2 products escape
# FlopCounterMode (ctypes), so utils/benchmarking.count_flops adds them.
ROWS = 0


def philox_bits(m: int, seed: int, device, rows_per_chunk: int = 1 << 15) -> torch.Tensor:
    """The kernel's random word for every element, int64 [m, 305]: word
    (e & 3) of Philox at counter e >> 2, e = row * 305 + channel."""
    out = torch.empty((m, C_ALL), dtype=torch.int64, device=device)
    flat = out.view(-1)
    for r0 in range(0, m, rows_per_chunk):
        e0, e1 = r0 * C_ALL, min(m, r0 + rows_per_chunk) * C_ALL
        flat[e0:e1] = philox_words(e0, e1, seed, device)
    return out


def coefficients(mean, var, scale, bias, w, w_bias, dt, eps: float = 1e-5):
    """float32 [5*305+2]: mu | a | beta | W[:,0] | W[:,1] | bias, the first
    five rounded to the input dtype (mask_head.py:195-200)."""
    a = torch.rsqrt(var.float() + eps) * scale.float()
    w2 = w.reshape(2, C_ALL).float()
    rows = [mean.float(), a, bias.float(), w2[0], w2[1]]
    rows = [r.to(dt).float() for r in rows]
    return torch.cat(rows + [w_bias.float().reshape(2)]).contiguous()


def mask_head_plain(x_up, ll, boundary, mean, var, scale, bias, w, w_bias,
                    seed: int = 0, rate: float = 0.1, eps: float = 1e-5, bits=None):
    """Plain version: concat, BN apply and ReLU in the input dtype, dropout
    (Philox bits from ``seed``, or the given ``bits`` [M, 305]), 1x1 conv
    with float32 sums. ``w`` is the conv weight [2, 305, 1, 1] (OIHW)."""
    dt = x_up.dtype
    lead = x_up.shape[:-1]
    coef = coefficients(mean, var, scale, bias, w, w_bias, dt, eps)
    mu, a, beta, w0, w1 = (coef[i * C_ALL:(i + 1) * C_ALL] for i in range(5))
    xf = torch.cat([x_up, ll, boundary], dim=-1).reshape(-1, C_ALL)
    h = torch.relu((xf - mu.to(dt)) * a.to(dt) + beta.to(dt))
    if rate > 0.0:
        if bits is None:
            bits = philox_bits(xf.shape[0], seed, xf.device)
        h = torch.where(bits < keep_threshold(rate), h * inv_keep(rate, dt),
                        torch.zeros((), dtype=dt, device=h.device))
    out = h.float() @ torch.stack([w0, w1], dim=1) + coef[5 * C_ALL:]
    return out.to(dt).reshape(*lead, 2)



def mask_head_bu_plain(x_bu, boundary, mean, var, scale, bias, w, w_bias,
                       seed: int = 0, rate: float = 0.1, eps: float = 1e-5, bits=None):
    """Plain version of K2: :func:`mask_head_plain` on the 256 | 48 split
    of x_bu [..., 304]."""
    return mask_head_plain(x_bu[..., :C_X], x_bu[..., C_X:], boundary, mean, var, scale, bias,
                           w, w_bias, seed, rate, eps, bits)


def _check_cuda_inputs(parts):
    """``parts``: (tensor, channels, name), the first one setting the
    device, dtype and leading shape."""
    first = parts[0][0]
    lead = first.shape[:-1]
    for t, c, name in parts:
        if not t.is_cuda or t.device != first.device:
            raise ValueError(f"{name} must be on {first.device}, got {t.device}")
        if t.dtype != first.dtype or t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes one of float32/bfloat16")
        if t.shape[:-1] != lead or t.shape[-1] != c:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(lead) + (c,)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous row-major [..., {c}] "
                             "(a channels_last NCHW tensor's NHWC view)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel stages it with "
                             "bulk copies)")


def launch(tensors, coef: torch.Tensor, seed: int, rate: float, library=None) -> torch.Tensor:
    """One launch of the kernel on the CUDA row views ``tensors`` (x_up,
    ll, boundary for K1; x_bu, boundary for K2) with the float32
    :func:`coefficients` ``coef`` already on their card; returns [..., 2]
    in their dtype. Uncounted: the wrappers count theirs. ``library``: a
    :class:`cuda_build.KernelLibrary` with the same entries (default
    :data:`LIBRARY`)."""
    first = tensors[0]
    dt = first.dtype
    entry = "uda_mask_head_split" if len(tensors) == 3 else "uda_mask_head"
    fn = getattr((library or LIBRARY).load(), entry)
    out = torch.empty(first.shape[:-1] + (2,), dtype=dt, device=first.device)
    err = fn(*(t.data_ptr() for t in tensors), coef.data_ptr(), out.data_ptr(),
             out.numel() // 2, seed & 0xFFFFFFFFFFFFFFFF, min(keep_threshold(rate), MASK32),
             inv_keep(rate, dt) if rate else 1.0, int(rate > 0.0), int(dt == torch.bfloat16),
             first.device.index, cuda_build.stream_of(first))
    cuda_build.check_launch(err, "mask-head")
    return out


def occupancy(split: bool, rate: float, dtype: torch.dtype, device) -> tuple[int, int]:
    """(dynamic shared memory per block in bytes, resident blocks per SM)
    of the kernel instance that a launch with these arguments runs."""
    import ctypes

    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = LIBRARY.load().uda_mask_head_occupancy(
        int(split), int(rate > 0.0), int(dtype == torch.bfloat16), torch.device(device).index or 0,
        ctypes.addressof(smem), ctypes.addressof(blocks))
    cuda_build.check_launch(err, "mask-head occupancy query")
    return smem.value, blocks.value


def _launch(tensors, coef_args, seed: int, rate: float, eps: float):
    first = tensors[0]
    coef = coefficients(*coef_args, first.dtype, eps).to(first.device)
    return launch(tensors, coef, seed, rate)


def fused_mask_head_split(x_up, ll, boundary, mean, var, scale, bias, w, w_bias,
                          seed: int, rate: float = 0.1, eps: float = 1e-5):
    """K1. x_up [..., 256], ll [..., 48], boundary [..., 1] (NHWC rows), the
    305-channel batch ``mean``/``var``, BN ``scale``/``bias`` [305], conv
    weight ``w`` [2, 305, 1, 1] and bias [2]; dropout at ``rate`` from the
    64-bit ``seed``. Returns [..., 2] in the input dtype."""
    if not x_up.is_cuda:
        return mask_head_plain(x_up, ll, boundary, mean, var, scale, bias, w, w_bias,
                               seed, rate, eps)
    global LAUNCHES, ROWS
    _check_cuda_inputs(((x_up, C_X, "x_up"), (ll, C_L, "ll"), (boundary, 1, "boundary")))
    out = _launch((x_up, ll, boundary), (mean, var, scale, bias, w, w_bias), seed, rate, eps)
    LAUNCHES += 1
    ROWS += out.numel() // 2
    return out


def fused_mask_head(x_bu, boundary, mean, var, scale, bias, w, w_bias,
                    seed: int, rate: float = 0.1, eps: float = 1e-5):
    """K2: the same epilogue over x_bu [..., 304] and boundary [..., 1].
    The element index of channel c of row r is r*305 + c, as in K1, so on
    ``x_bu = cat(x_up, ll)`` with the same seed the two agree bitwise."""
    if not x_bu.is_cuda:
        return mask_head_bu_plain(x_bu, boundary, mean, var, scale, bias, w, w_bias,
                                  seed, rate, eps)
    global LAUNCHES_BU, ROWS
    _check_cuda_inputs(((x_bu, C_X + C_L, "x_bu"), (boundary, 1, "boundary")))
    out = _launch((x_bu, boundary), (mean, var, scale, bias, w, w_bias), seed, rate, eps)
    LAUNCHES_BU += 1
    ROWS += out.numel() // 2
    return out
