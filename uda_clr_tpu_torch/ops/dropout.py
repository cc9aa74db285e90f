"""Fused dropout, forward and backward (K3): zero an element with
probability ``rate`` and scale the survivors by 1/keep rounded to the input
dtype, in one pass.

Replaces the TPU kernel ``uda_clr_tpu/ops/pallas/dropout.py:_dropout_kernel``
(``_apply``, custom VJP ``dropout_pallas``). :func:`fused_dropout` is a
``torch.autograd.Function``: on a CUDA tensor its forward and its backward
each launch the hand-written kernel ``csrc/dropout.cu`` (the backward on
the cotangent with the same seed, so the mask is regenerated, never
stored), or raise; there is no fallback. On a CPU tensor both run
:func:`dropout_plain`, which replays the kernel's Philox4x32-10 stream, so
the two agree elementwise.

The element index of the stream is the element's offset in memory: on the
card the model's activations are ``channels_last`` (physically NHWC), and
the kernel walks memory in order. The plain version replays that order,
and the backward brings the cotangent to the forward's memory format before
its launch, since autograd may hand it another.

The kernel's least time is set by bytes (one read of x, one write of y);
see the source for its design and PERF.md for its times. Built with
``nvcc`` for sm_90a into ``build/kernels/`` at first use (ops/cuda_build.py).
"""

from __future__ import annotations

import torch

from uda_clr_tpu_torch.ops import cuda_build
from uda_clr_tpu_torch.ops.cuda_build import F32, I64, INT, P, U32, U64
from uda_clr_tpu_torch.ops.philox import inv_keep, keep_threshold, philox_words

LIBRARY = cuda_build.KernelLibrary("dropout.cu", {
    "uda_dropout": [P, P, I64, U64, U32, F32, INT, INT, P],
})

# Launches of the CUDA kernel by the Function's forward and backward, and
# the bytes they moved (each reads its input and writes its output once)
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0
BYTES = 0

_CHUNK = 1 << 24  # elements per step of the plain version's Philox replay



def memory_format(x: torch.Tensor) -> torch.memory_format:
    """The format ``x`` is dense in: channels_last for a 4-D tensor laid out
    NHWC, else contiguous (a tensor dense in both has the same offsets in
    either)."""
    if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def _dense(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself if it is dense in its memory format, else a contiguous
    copy."""
    return x.contiguous(memory_format=memory_format(x))


def _memory_order(t: torch.Tensor) -> torch.Tensor:
    """A contiguous view of a dense ``t`` whose flat index is the memory
    offset."""
    if memory_format(t) == torch.channels_last:
        return t.permute(0, 2, 3, 1)
    return t


def dropout_plain(x: torch.Tensor, seed: int, rate: float, bits=None) -> torch.Tensor:
    """Plain version: ``where(word(e) < floor(keep*2^32), x * round_dt(1/keep),
    0)`` with e the memory offset and the words from ``seed`` (or the
    given int64 ``bits`` in memory order). Same memory format as ``x``."""
    x = _dense(x)
    y = torch.empty_like(x)
    xf, yf = _memory_order(x).reshape(-1), _memory_order(y).view(-1)
    threshold, scale = keep_threshold(rate), inv_keep(rate, x.dtype)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    n = xf.numel()
    for e0 in range(0, n, _CHUNK):
        e1 = min(n, e0 + _CHUNK)
        words = philox_words(e0, e1, seed, x.device) if bits is None else bits[e0:e1]
        yf[e0:e1] = torch.where(words < threshold, xf[e0:e1] * scale, zero)
    return y


def launch(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """One launch of the kernel on the CUDA tensor ``x`` (uncounted; the
    Function's forward and backward count theirs)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {x.dtype}; the kernel takes one of float32/bfloat16")
    x = _dense(x)
    if x.data_ptr() % (4 * x.element_size()):
        x = x.clone()  # a fresh allocation is aligned for the 4-element vector loads
    y = torch.empty_like(x)
    err = LIBRARY.load().uda_dropout(
        x.data_ptr(), y.data_ptr(), x.numel(), seed & 0xFFFFFFFFFFFFFFFF, keep_threshold(rate),
        inv_keep(rate, x.dtype), int(x.dtype == torch.bfloat16), x.device.index,
        cuda_build.stream_of(x))
    cuda_build.check_launch(err, "dropout")
    return y


def _apply(x: torch.Tensor, seed: int, rate: float, backward: bool) -> torch.Tensor:
    if not x.is_cuda:
        return dropout_plain(x, seed, rate)
    global LAUNCHES_FWD, LAUNCHES_BWD, BYTES
    y = launch(x, seed, rate)
    BYTES += 2 * y.numel() * y.element_size()
    if backward:
        LAUNCHES_BWD += 1
    else:
        LAUNCHES_FWD += 1
    return y


class _FusedDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed: int, rate: float):
        ctx.seed, ctx.rate, ctx.format = seed, rate, memory_format(x)
        return _apply(x, seed, rate, backward=False)

    @staticmethod
    def backward(ctx, g):
        # the mask follows memory offsets: lay g out as the forward's x was
        g = g.contiguous(memory_format=ctx.format)
        return _apply(g, ctx.seed, ctx.rate, backward=True), None, None


def fused_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Dropout of ``x`` at ``rate`` from the 64-bit ``seed``; identity at
    rate 0 (as the JAX package's TpuDropout)."""
    if rate == 0.0:
        return x
    return _FusedDropout.apply(x, seed, rate)
