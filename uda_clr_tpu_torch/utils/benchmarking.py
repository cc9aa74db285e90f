"""Shared benchmark scaffolding of the port (the counterpart of
uda_clr_tpu/utils/benchmarking.py): first call, warm-up, timed windows,
their median, and the share of the card's peak that the timed work reached.
``bench.py`` and ``bench_eval.py`` measure through it, so a barrier or
methodology fix lands once.

* Every clock stops on ``float(barrier)`` of a scalar that depends on the
  timed work. On a CUDA tensor that ``.item()`` waits for the card, so the
  window holds the device's work and not only its enqueueing.
* Steps chain through the carry, so one fetch at the end of a window forces
  the whole window.
* ``window_ms`` is reported sorted with its median: several independent
  windows keep one slow window from moving a headline alone.

The JAX package also enables XLA's persistent compile cache here; the port
has no compile step to cache. What its first call builds, the hand-written
kernels, is cached by the digest of their sources (ops/cuda_build.py).

``mfu`` is not the JAX package's. JAX's ``cost_mfu`` divides the flops of
XLA's ``cost_analysis()``, elementwise work included. The port counts the
flops of the work itself: the convolutions, their two gradients and the
matrix products, each gradient costing what its forward costs, whichever
implementation runs them (:func:`count_flops`). Elementwise work, norms,
resizes and the dropout draws count nothing. The two ``mfu`` numbers are
therefore not comparable.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Tuple

import numpy as np
import torch

StepOnce = Callable[[Any], Tuple[Any, Any]]

# K1 and K2's 1x1 conv 305 -> 2 per row (one multiply and one add per
# product). They are bound through ctypes, so FlopCounterMode does not see
# their CUDA launches; their plain versions' matrix product it does see.
MASK_HEAD_FLOPS_PER_ROW = 2 * 305 * 2


# the train step's arguments in every benchmark: lr_gen, lr_dis, and an
# epoch past the reference's 20 warmup epochs
LR_GEN, LR_DIS, EPOCH = 1e-3, 2.5e-5, 30


def flagship_config(norm: str = "bn", method: str = "prototype_full"):
    """The configuration the benchmarks and measurement tools time: the
    reference's production step (mobilenet DeepLabv3+ OS16, T=8 MC
    samples, bfloat16) under ``norm``."""
    from uda_clr_tpu_torch.config import Config

    cfg = Config()
    cfg.model.compute_dtype = "bfloat16"
    cfg.model.norm = norm
    cfg.method.method = method
    cfg.method.mc_samples = 8  # the reference's T
    return cfg


def timed_window(step_once: StepOnce, carry, iters: int):
    """One window of ``iters`` chained calls; returns ``(carry, ms per
    call)``, the clock stopped on ``float(barrier)`` of the last."""
    t0 = time.perf_counter()
    for _ in range(iters):
        carry, barrier = step_once(carry)
    float(barrier)
    return carry, (time.perf_counter() - t0) / iters * 1000.0


def timed_windows(step_once: StepOnce, carry, windows: int = 5, iters: int = 10,
                  warmup: int = 2):
    """The first call (timed), ``warmup`` more, then ``windows`` windows of
    ``iters`` chained calls each.

    ``step_once(carry) -> (carry, barrier)``, ``barrier`` a 0-d tensor that
    depends on the call's whole computation; ``float(barrier)`` stops each
    clock. Returns ``(carry, stats)``, ``stats = {"first_call_s",
    "window_ms" (sorted), "median_ms", "window_ms_run_order"}``. The first
    call holds what a fresh process builds: the kernels' build or load and
    cuDNN's algorithm search.
    """
    t0 = time.perf_counter()
    carry, barrier = step_once(carry)
    float(barrier)
    first_call_s = time.perf_counter() - t0
    for _ in range(warmup):
        carry, barrier = step_once(carry)
    float(barrier)
    window_ms = []
    for _ in range(windows):
        carry, ms = timed_window(step_once, carry, iters)
        window_ms.append(ms)
    return carry, {
        "first_call_s": first_call_s,
        "window_ms": sorted(window_ms),
        "median_ms": float(np.median(window_ms)),
        "window_ms_run_order": window_ms,
    }


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                         _dilation, transposed, _output_padding, _groups, output_mask,
                         out_shape=None, **_):
    """Each gradient of a convolution costs what its forward costs.
    FlopCounterMode's own rule counts a grouped conv's weight gradient with
    every input channel against every output channel, ``groups`` times the
    forward (960 times for mobilenet's widest depthwise conv)."""
    from torch.utils.flop_counter import conv_flop_count

    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def flop_counter():
    """A ``FlopCounterMode`` whose convolution gradients each cost their
    forward (:func:`_conv_backward_flops`)."""
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})


def count_flops(fn: Callable[[], Any]):
    """Run ``fn()`` once under ``torch.utils.flop_counter.FlopCounterMode``;
    returns ``(fn's result, flops)``. Counts the convolutions, both of their
    gradients and the matrix products, plus the 305 -> 2 products of the
    mask-head kernels' CUDA launches, which FlopCounterMode cannot see."""
    from uda_clr_tpu_torch.ops import mask_head

    rows0 = mask_head.ROWS
    counter = flop_counter()
    with counter:
        out = fn()
    rows = mask_head.ROWS - rows0
    return out, counter.get_total_flops() + MASK_HEAD_FLOPS_PER_ROW * rows


def mfu(flops: float, median_ms: float, device_name: str):
    """``(mfu, tflops)``: the share of the card's dense bf16 peak that
    ``flops`` per ``median_ms`` reach (None for a card that
    ``devinfo.peak_tflops`` does not know), and ``flops`` in TFLOP."""
    from uda_clr_tpu_torch.utils.devinfo import peak_tflops

    peak = peak_tflops(device_name)
    tflops = flops / 1e12
    return (tflops / (median_ms / 1e3) / peak if peak else None), tflops


def oom_message(exc: BaseException, limit: int = 160) -> str:
    """A one-line error for a failed (typically out-of-memory) variant: the
    part of ``torch.cuda.OutOfMemoryError``'s message from "out of memory"
    on, at most ``limit`` characters."""
    msg = " ".join(str(exc).split())
    cut = msg.lower().find("out of memory")
    if cut >= 0:
        msg = msg[cut:]
    return msg[:limit]


def staged_train_batch(batch: int, size: int, device, seed: int = 0,
                       wire: str = "f32") -> dict:
    """The benchmarks' random train batch (image_s, map_s, boundary_s,
    image_t), NHWC at ``size``², staged on ``device`` once.

    ``wire="u8"`` stages it in the uint8 wire format (data/wire.py), so the
    timed step is the one that decodes on the device, as a u8 host-fed step
    does; otherwise the (small) decode would be counted as host overhead."""
    rng = np.random.default_rng(seed)
    shape = (batch, size, size)
    if wire == "u8":
        arrs = {
            "image_s": rng.integers(0, 256, shape + (3,), dtype=np.uint8),
            "map_s": rng.integers(0, 2, shape + (2,), dtype=np.uint8),
            "boundary_s": rng.integers(0, 256, shape + (1,), dtype=np.uint8),
            "image_t": rng.integers(0, 256, shape + (3,), dtype=np.uint8),
        }
    elif wire == "f32":
        arrs = {
            "image_s": rng.standard_normal(shape + (3,)).astype(np.float32),
            "map_s": (rng.uniform(0, 1, shape + (2,)) > 0.5).astype(np.float32),
            "boundary_s": rng.uniform(0, 1, shape + (1,)).astype(np.float32),
            "image_t": rng.standard_normal(shape + (3,)).astype(np.float32),
        }
    else:
        raise ValueError(f"wire {wire!r}; 'f32' or 'u8'")
    return {k: torch.from_numpy(v).to(device) for k, v in arrs.items()}
