"""Shared conv building blocks (uda_clr_tpu/models/layers.py).

Modules are NCHW; on the card they hold ``torch.channels_last`` tensors,
which are physically NHWC. Parameters stay float32; every conv casts its
weight to the activation dtype (the JAX package's ``dtype=bfloat16`` with
``param_dtype=float32``). The port takes explicit casts, not autocast:
activations are cast once at the model input and stay in that dtype.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from uda_clr_tpu_torch.models.norm import DomainNorm2d, current_rows, frozen_stats, global_rows
from uda_clr_tpu_torch.ops.dropout import fused_dropout
from uda_clr_tpu_torch.ops.philox import MASK64, splitmix64
from uda_clr_tpu_torch.parallel import spatial


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 weight (and bias) is cast to the input's
    dtype, as flax's ``nn.Conv(dtype=..., param_dtype=float32)`` does.
    Under the spatial mesh its H padding is halo rows from the neighbouring
    stripes (parallel/spatial.py); a conv without H padding reads its own
    rows or those its caller fetched (:func:`fixed_padding`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        conv = spatial.conv2d if spatial.active() else F.conv2d
        return conv(x, self.weight.to(x.dtype), bias, self.stride,
                    self.padding, self.dilation, self.groups)


def init_conv_(conv: nn.Conv2d, generator: torch.Generator, std: float | None = None):
    """JAX-package init: kaiming-normal fan_in (gain^2=2) or N(0, std)
    (the discriminators' N(0, 0.02)); zero bias."""
    with torch.no_grad():
        if std is None:
            nn.init.kaiming_normal_(conv.weight, mode="fan_in",
                                    nonlinearity="relu", generator=generator)
        else:
            nn.init.normal_(conv.weight, 0.0, std, generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()


def fixed_pads(kernel_size: int, dilation: int) -> tuple[int, int]:
    """(before, after) padding of :func:`fixed_padding` on each axis."""
    pad_total = kernel_size + (kernel_size - 1) * (dilation - 1) - 1
    return pad_total // 2, pad_total - pad_total // 2


def fixed_padding(x: torch.Tensor, kernel_size: int, dilation: int) -> torch.Tensor:
    """Pre-pad for 'same' output under stride (layers.py:57-68). MobileNet
    pads the *block input*, so the expansion conv's BN sees the border.
    Under the spatial mesh the rows come from the neighbouring stripes
    (zeros at the image's edges)."""
    beg, end = fixed_pads(kernel_size, dilation)
    if spatial.active():
        return F.pad(spatial.halo_rows(x, beg, end), (beg, end, 0, 0))
    return F.pad(x, (beg, end, beg, end))


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """ResNet's stem pool, ``nn.MaxPool2d(3, 2, 1)`` (uda_clr_tpu/models/resnet.py
    :18-20): the border pads with -inf, not 0 (under the spatial mesh the
    row above a stripe is its neighbour's, -inf above the image)."""
    if spatial.active():
        top, bottom = spatial.conv_halo(3, 2, 1, 1, x.shape[2])
        return F.max_pool2d(spatial.halo_rows(x, top, bottom, "-inf"), 3, 2, (0, 1))
    return F.max_pool2d(x, 3, 2, 1)


def run_block(block: nn.Module, x: torch.Tensor, train: bool, domains: int,
              remat: bool) -> torch.Tensor:
    """``block(x, train, domains)``; with ``remat``, in a train-mode forward
    that records gradients, rematerialised as the JAX package's ``nn.remat``
    does (mobilenet.py:94-110): only the block's input is kept, and the
    backward recomputes the inside under :func:`frozen_stats`, so the
    recompute normalises with the same batch moments (no norm reads its
    running stats in train mode) and writes the running stats no second
    time. Backbones draw no random numbers, so no generator state is kept.
    The recompute, which runs in the backward, restores the forward's
    one-domain row layout (norm.global_rows)."""
    if remat and train and torch.is_grad_enabled():
        rows = current_rows()

        @contextlib.contextmanager
        def recompute():
            with frozen_stats(block), global_rows(rows):
                yield

        return checkpoint(block, x, train, domains, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(), recompute()))
    return block(x, train, domains)


# Dropout backend, the JAX package's five names (uda_clr_tpu/models/layers.py
# :71-100), read at every call:
#   'xla16' (default) - 16-bit random words, kept when < min(round(keep *
#     65536), 65535): keep probability quantised to 2^-16;
#   'xla' - exact-rate Bernoulli from float32 uniforms;
#   'pallas' / 'auto' - the fused dropout kernel K3 (ops/dropout.py): on a
#     CUDA tensor it launches, on a CPU tensor its plain version runs;
#   'off' - every dropout an identity while batch norm stays in train mode
#     (the parity tests: the two frameworks' random streams cannot coincide).
# The masks of the first two come from the stream's torch.Generator; K3 draws
# from a 64-bit seed per site. Survivors are x / round_dt(keep) rounded to
# x's dtype (layers.py:138); K3 scales by round_dt(1/keep), as its TPU kernel.
IMPLS = ("auto", "xla", "xla16", "pallas", "off")
_DROPOUT_IMPL = "xla16"


def set_dropout_impl(impl: str) -> None:
    global _DROPOUT_IMPL
    if impl not in IMPLS:
        raise ValueError(f"dropout impl {impl!r}; one of {IMPLS}")
    _DROPOUT_IMPL = impl


def dropout_impl() -> str:
    return _DROPOUT_IMPL


class DropoutStream:
    """The random source of one forward's dropout sites: ``generator`` for
    the mask draws of 'xla16'/'xla', and a fresh 64-bit K3 seed per site
    (splitmix64 of ``seed`` and the site's index; host integers, no
    device sync)."""

    def __init__(self, generator: torch.Generator | None, seed: int = 0):
        self.generator = generator
        self.seed = seed
        self.sites = 0

    def next_seed(self) -> int:
        self.sites += 1
        return splitmix64((self.seed + self.sites) & MASK64)


def _bernoulli_mask(x: torch.Tensor, keep: float, generator, sixteen_bit: bool) -> torch.Tensor:
    """The keep mask of 'xla16' (sixteen_bit) or 'xla', in x's memory format."""
    if sixteen_bit:
        thr = min(int(round(keep * 65536.0)), 65535)
        bits = torch.empty_like(x, dtype=torch.int16).random_(-32768, 32768, generator=generator)
        return bits < thr - 32768
    u = torch.empty_like(x, dtype=torch.float32).uniform_(generator=generator)
    return u < keep


def apply_keep_mask(x: torch.Tensor, mask: torch.Tensor, rate: float) -> torch.Tensor:
    """``where(mask, x / round_dt(keep), 0)`` rounded to x's dtype, exactly
    the JAX package's ``jnp.where(mask, x / keep, 0)`` for a weakly typed
    keep. keep is a device tensor: a CPU scalar would turn the division into
    a multiply by its reciprocal on the card."""
    keep_t = torch.full((), 1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / keep_t, torch.zeros((), dtype=x.dtype, device=x.device))


def bernoulli_dropout(x: torch.Tensor, rate: float, generator, sixteen_bit: bool) -> torch.Tensor:
    return apply_keep_mask(x, _bernoulli_mask(x, 1.0 - rate, generator, sixteen_bit), rate)


def dropout(x: torch.Tensor, rate: float, stream: DropoutStream | None,
            train: bool = True) -> torch.Tensor:
    """A model dropout site under the current backend (TpuDropout,
    layers.py:102-138)."""
    impl = _DROPOUT_IMPL
    if not train or rate == 0.0 or impl == "off":
        return x
    if impl in ("pallas", "auto"):
        return fused_dropout(x, stream.next_seed(), rate)
    return bernoulli_dropout(x, rate, stream.generator, impl == "xla16")


def mc_dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """A dropout site of the MC pass (steps.py:_mc_drop :110-125): the same
    backends but never the kernel; under 'pallas'/'auto' it draws
    exact-rate Bernoulli masks."""
    impl = _DROPOUT_IMPL
    if impl == "off" or rate == 0.0:
        return x
    return bernoulli_dropout(x, rate, generator, impl == "xla16")


class Dropout(nn.Module):
    """Parameter-free slot with the reference's index in its Sequential."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool, stream: DropoutStream | None):
        return dropout(x, self.rate, stream, train)


def run_layers(layers, x, train: bool, domains: int, stream=None):
    """Apply a reference-indexed layer list: norms take (train, domains),
    dropouts (train, stream), everything else x alone."""
    for layer in layers:
        if isinstance(layer, DomainNorm2d):
            x = layer(x, train, domains)
        elif isinstance(layer, Dropout):
            x = layer(x, train, stream)
        else:
            x = layer(x)
    return x
