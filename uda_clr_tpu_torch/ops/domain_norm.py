"""The domain-aware batch norm as a hand-written kernel (K4): per-group
float32 moments, normalize with the running stats' EMA in its epilogue,
and the backward's reduce and dx passes, on CUDA activations.

Replaces no Pallas kernel: the JAX package leaves the norm
(``uda_clr_tpu/models/norm.py``) to XLA's fusion. The plain version is
``models/norm.py``'s op-by-op code (``_moments``, ``normalize_plain``,
``DomainNorm2d.forward_plain``), which CPU tensors take, so every CPU test
sees the same bits as before; ``models/norm.py`` routes CUDA tensors here,
where each entry launches ``csrc/domain_norm.cu`` or raises. There is no
fallback. A tensor being traced (``torch.export``, ``torch.compile``, fake
tensors) takes the plain version too: a ctypes launch cannot be traced, and
the exported artifact holds ATen ops alone.

An activation ``x`` [N, C, H, W] in bfloat16 or float32, channels_last or
contiguous NCHW, has its first ``k`` images in group 0 (the source half)
and the rest in group 1 (``k == N``: one group). A site runs
:func:`moments` (the float32 sums of x and x^2 per group and channel and
each group's count, packed in one buffer; under data parallelism the
buffers of a call are ``all_sum``-med in one collective) and then
:func:`normalize` (an autograd Function: y in x's type, rounded once; the
EMA of the running stats in place; mean and rstd kept for the backward,
which saves ``x`` in its own type and no float32 copy). Its backward
reduces ``[sum dy, sum dy * xhat]`` per group and channel (``all_sum``-med
across ranks for dx, kept local for the parameters' gradients, which the
step averages) and writes dx in one elementwise pass.
:func:`normalize_fixed` normalizes with given statistics (eval mode, the MC
suffix), whose gradient, if any, reaches x and the affine only.

Bound: bytes, 2 B an element (bf16) for the moments, 4 for the forward, 4
for the reduce and 6 for dx; the source has the design, PERF.md the times.
Built with ``nvcc`` for sm_90a into ``build/kernels/`` at first use
(ops/cuda_build.py).
"""

from __future__ import annotations

import functools
import math

import torch
from torch._subclasses.fake_tensor import is_fake

from uda_clr_tpu_torch.ops import cuda_build
from uda_clr_tpu_torch.ops.cuda_build import F32, I64, INT, P
from uda_clr_tpu_torch.parallel.distributed import world_size
from uda_clr_tpu_torch.parallel.reduce import all_sum

# n, c, hw, k, groups, cl, vec, lanes, rows_per_pass, tiles, chunks0, chunks1
_GEOM = [INT, INT, I64, INT, INT, INT, INT, INT, INT, INT, INT, INT]
_TAIL = [INT, INT, P]  # is_bf16, device, stream
LIBRARY = cuda_build.KernelLibrary("domain_norm.cu", {
    "uda_norm_moments": [P, P, P, *_GEOM, *_TAIL],
    "uda_norm_forward": [P, P, P, P, P, P, P, F32, P, P, P, P, P, F32, F32, *_GEOM, *_TAIL],
    "uda_norm_bwd_reduce": [P, P, P, P, P, *_GEOM, *_TAIL],
    "uda_norm_bwd_dx": [P, P, P, P, P, P, P, *_GEOM, *_TAIL],
    "uda_norm_tn_factor": [P, INT, F32, P, INT, P],
})

# Launches of each entry, and the bytes of their byte bound (moments: x
# read; forward: x read, y written; reduce: dy and x read; dx: dy and x
# read, dx written)
LAUNCHES_MOMENTS = 0
LAUNCHES_FWD = 0
LAUNCHES_REDUCE = 0
LAUNCHES_BWD = 0
BYTES = 0

_THREADS = 256  # threads of a block at most (csrc/domain_norm.cu kThreads)
# the channels_last grid's aim in blocks an SM: 4 with 16-byte vectors (16
# KB of loads in flight a block), 8 with narrower ones
_BLOCKS_PER_SM = (8, 4)
_MIN_PASSES = 16  # row passes a thread makes at least, where the rows allow


def launches_on(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the kernel: a real CUDA tensor, not one being
    traced."""
    return x.is_cuda and not torch.compiler.is_compiling() and not is_fake(x)


def channels_last(x: torch.Tensor) -> bool:
    """True for a channels_last [N, C, H, W] activation, False for a
    contiguous NCHW one (where both hold, the two index maps are the same);
    anything else raises."""
    if x.dim() != 4:
        raise ValueError(f"the norm kernel takes [N, C, H, W], got {tuple(x.shape)}")
    if x.is_contiguous(memory_format=torch.channels_last):
        return True
    if x.is_contiguous():
        return False
    raise ValueError(f"the norm kernel takes a channels_last or contiguous NCHW activation; "
                     f"strides {x.stride()} for shape {tuple(x.shape)}")


def _check(x: torch.Tensor) -> bool:
    if not x.is_cuda:
        raise ValueError(f"the norm kernel takes a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {x.dtype}; the norm kernel takes float32 or bfloat16")
    return channels_last(x)


def _vector(t: torch.Tensor, c: int, name: str, device) -> None:
    """Raise unless ``t`` is a contiguous float32 [c] on ``device``."""
    if t.dtype != torch.float32 or t.device != device:
        raise TypeError(f"{name}: {t.dtype} on {t.device}; the norm kernel takes float32 "
                        f"on {device}")
    if t.shape != (c,) or not t.is_contiguous():
        raise ValueError(f"{name}: shape {tuple(t.shape)} strides {t.stride()}; the norm "
                         f"kernel takes a contiguous [{c}]")


@functools.lru_cache(maxsize=1024)
def _plan(n: int, c: int, hw: int, k: int, groups: int, cl: bool, itemsize: int, align: int,
          sms: int) -> tuple:
    """The launch's geometry, the entries' 12 shape arguments: the vector
    width (the widest of at most 16 bytes that divides the contiguous run,
    C or H*W, and the pointers' alignment), and for channels_last the lanes
    (channel vectors of a tile), rows per pass, channel tiles and each
    group's row chunks (about :data:`_BLOCKS_PER_SM` blocks an SM over both
    groups, each thread ``_MIN_PASSES`` passes at least); NCHW's chunks are
    the groups' images."""
    run = c if cl else hw
    vec = 16 // itemsize
    while vec > 1 and (run % vec or align % (vec * itemsize)):
        vec //= 2
    if not cl:
        return (n, c, hw, k, groups, 0, vec, _THREADS, 1, 1, k, n - k)
    vectors = c // vec
    tiles = -(-vectors // _THREADS)
    lanes = -(-vectors // tiles)
    rows_per_pass = max(1, _THREADS // lanes)
    rows = (k * hw, (n - k) * hw)
    target = max(1, _BLOCKS_PER_SM[vec * itemsize == 16] * sms // tiles)

    def chunks(r: int) -> int:
        if r == 0:
            return 0
        return max(1, min(-(-r // (rows_per_pass * _MIN_PASSES)), -(-target * r // (n * hw))))

    return (n, c, hw, k, groups, 1, vec, lanes, rows_per_pass, tiles, *map(chunks, rows))


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _alignment(*tensors) -> int:
    a = 16
    for t in tensors:
        a = math.gcd(a, t.data_ptr())
    return a


def plan_of(x: torch.Tensor, k: int | None, *more) -> tuple:
    """:func:`_plan` for ``x`` split at ``k`` (None: one group) and the
    other tensors of the same shape and layout that the launch reads or
    writes."""
    n, c, h, w = x.shape
    if k is not None and not 0 <= k <= n:
        raise ValueError(f"split {k} of a batch of {n}")
    return _plan(n, c, h * w, n if k is None else k, 1 if k is None else 2, channels_last(x),
                 x.element_size(), _alignment(x, *more), _sms(x.device.index))


def _partials(geom: tuple) -> int:
    """Floats of the partial rows of a reduction with this geometry."""
    return (geom[10] + geom[11]) * 2 * geom[1]


def _tail(x: torch.Tensor) -> tuple:
    return int(x.dtype == torch.bfloat16), x.device.index, cuda_build.stream_of(x)


def stats_size(c: int, groups: int) -> int:
    """Floats of a moments buffer: [sum x][groups][c], [sum x^2][groups][c],
    the groups' counts."""
    return (2 * c + 1) * groups


def moments(parts) -> list[torch.Tensor]:
    """The packed moments buffer (:func:`stats_size` floats) of each ``(x,
    k)`` in ``parts`` (``x`` split at ``k``; None: one group), over the
    global batch: under data parallelism one ``all_sum`` of every part's
    sums and counts."""
    global LAUNCHES_MOMENTS, BYTES
    geoms, sizes = [], []
    for x, k in parts:
        _check(x)
        geoms.append(plan_of(x, k))
        sizes.append(stats_size(x.shape[1], geoms[-1][4]))
    lib = LIBRARY.load()
    total = sum(sizes)
    # the packed buffers, then the partial rows (reused by every part)
    work = torch.empty(total + max(map(_partials, geoms)), dtype=torch.float32,
                       device=parts[0][0].device)
    base = work.data_ptr()
    offset = 0
    for (x, _), geom, size in zip(parts, geoms, sizes):
        err = lib.uda_norm_moments(x.data_ptr(), base + 4 * total, base + 4 * offset, *geom,
                                   *_tail(x))
        cuda_build.check_launch(err, "norm moments")
        LAUNCHES_MOMENTS += 1
        BYTES += x.numel() * x.element_size()
        offset += size
    packed = work[:total]
    if world_size() > 1:
        with torch.no_grad():
            packed = all_sum(packed)
    return list(packed.split(sizes)) if len(sizes) > 1 else [packed]


def mean_var(stats: torch.Tensor, groups: int, c: int):
    """(mean [groups, c], biased variance [groups, c], count [groups]) of a
    moments buffer, in float32: E[x^2] - E[x]^2 clamped at >= 0."""
    sums = stats[:2 * groups * c].view(2, groups, c)
    n = stats[2 * groups * c:]
    mean = sums[0] / n[:, None]
    return mean, torch.clamp(sums[1] / n[:, None] - mean * mean, min=0.0), n


def tn_factor(stats: torch.Tensor, c: int, eps: float) -> torch.Tensor:
    """TransNorm's detached float32 [c] factor ``a1`` from a two-group
    moments buffer (``models/norm.py:transfer_factor`` of the groups' means
    and unbiased variances), in one launch."""
    if stats.numel() != stats_size(c, 2) or stats.dtype != torch.float32 or not stats.is_cuda:
        raise ValueError(f"a two-group moments buffer of {c} channels, got {stats.numel()} "
                         f"{stats.dtype} on {stats.device}")
    a1 = torch.empty(c, dtype=torch.float32, device=stats.device)
    err = LIBRARY.load().uda_norm_tn_factor(stats.data_ptr(), c, eps, a1.data_ptr(),
                                             stats.device.index, cuda_build.stream_of(stats))
    cuda_build.check_launch(err, "TransNorm factor")
    return a1


class _Normalize(torch.autograd.Function):
    """y = (x - mean) * rstd * scale + bias with the batch statistics of a
    :func:`moments` buffer (``var`` None) or the given mean and variance
    (constants); ``ema``: each group's running (mean, var), or None."""

    @staticmethod
    def forward(ctx, x, scale, bias, stats, var, k: int | None, eps: float, ema,
                momentum: float):
        global LAUNCHES_FWD, BYTES
        cl = _check(x)
        c = x.shape[1]
        geom = plan_of(x, k, x)
        groups = geom[4]
        _vector(scale, c, "scale", x.device)
        _vector(bias, c, "bias", x.device)
        batch = var is None
        if batch:
            if stats.numel() != stats_size(c, groups):
                raise ValueError(f"a moments buffer of {stats.numel()} floats for "
                                 f"{groups} groups of {c} channels")
            base = stats.data_ptr()
            a, b, counts = base, base + 4 * groups * c, base + 8 * groups * c
        else:
            _vector(stats, c, "mean", x.device)
            _vector(var, c, "var", x.device)
            a, b, counts = stats.data_ptr(), var.data_ptr(), 0
        running = [0] * 4  # (mean, var) of group 0, then of group 1
        for i, pair in enumerate(ema if batch and ema else ()):
            for j, (t, name) in enumerate(zip(pair, ("running mean", "running var"))):
                _vector(t, c, name, x.device)
                running[2 * i + j] = t.data_ptr()
        saved = torch.empty(2 * groups * c, dtype=torch.float32, device=x.device)
        y = torch.empty_like(x)
        err = LIBRARY.load().uda_norm_forward(
            x.data_ptr(), y.data_ptr(), a, b, counts, scale.data_ptr(), bias.data_ptr(), eps,
            saved.data_ptr(), *running, momentum, 1.0 - momentum, *geom, *_tail(x))
        cuda_build.check_launch(err, "norm forward")
        LAUNCHES_FWD += 1
        BYTES += 2 * x.numel() * x.element_size()
        ctx.save_for_backward(x, scale, saved, stats if batch else None)
        ctx.k, ctx.cl, ctx.batch = k, cl, batch
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, saved, stats = ctx.saved_tensors
        need_x, need_scale, need_bias = ctx.needs_input_grad[:3]
        dy = dy.contiguous(memory_format=torch.channels_last if ctx.cl else
                           torch.contiguous_format)
        if dy.dtype != x.dtype:
            raise TypeError(f"cotangent {dy.dtype} for an activation of {x.dtype}")
        red = None
        if need_scale or need_bias or (need_x and ctx.batch):
            red = reduce_launch(dy, x, saved, ctx.k)
        dx = None
        if need_x:
            # batch statistics: the cotangent reaches x through them too,
            # from every rank's rows
            dx = dx_launch(dy, x, saved, scale, ctx.k, all_sum(red) if ctx.batch else None,
                           stats)
        dscale = dbias = None
        if red is not None:
            # the affine serves both groups: its gradient sums them
            sums = red[:, 0] if red.shape[1] == 1 else red.sum(1)
            dscale = sums[1] if need_scale else None
            dbias = sums[0] if need_bias else None
        return dx, dscale, dbias, None, None, None, None, None, None


def reduce_launch(dy, x, saved, k: int | None) -> torch.Tensor:
    """The backward's reduce: [sum dy, sum dy * xhat] [2, groups, C] over
    this rank's rows, from the forward's ``saved`` mean and rstd."""
    global LAUNCHES_REDUCE, BYTES
    geom = plan_of(x, k, dy)
    groups, c = geom[4], geom[1]
    work = torch.empty(2 * groups * c + _partials(geom), dtype=torch.float32, device=x.device)
    err = LIBRARY.load().uda_norm_bwd_reduce(
        dy.data_ptr(), x.data_ptr(), saved.data_ptr(), work.data_ptr() + 8 * groups * c,
        work.data_ptr(), *geom, *_tail(x))
    cuda_build.check_launch(err, "norm backward reduce")
    LAUNCHES_REDUCE += 1
    BYTES += 2 * x.numel() * x.element_size()
    return work[:2 * groups * c].view(2, groups, c)


def dx_launch(dy, x, saved, scale, k: int | None, red=None, stats=None) -> torch.Tensor:
    """The backward's dx: with the reduce's global sums ``red`` and the
    moments buffer ``stats`` (for the counts) where the forward took batch
    statistics, else (None, None) for constant ones."""
    global LAUNCHES_BWD, BYTES
    dx = torch.empty_like(x)
    geom = plan_of(x, k, dy, dx)
    groups, c = geom[4], geom[1]
    err = LIBRARY.load().uda_norm_bwd_dx(
        dy.data_ptr(), x.data_ptr(), dx.data_ptr(), saved.data_ptr(),
        0 if red is None else red.data_ptr(),
        0 if stats is None else stats.data_ptr() + 8 * groups * c, scale.data_ptr(), *geom,
        *_tail(x))
    cuda_build.check_launch(err, "norm backward dx")
    LAUNCHES_BWD += 1
    BYTES += 3 * x.numel() * x.element_size()
    return dx


def normalize(x, stats, k: int | None, scale, bias, eps: float, ema=None,
              momentum: float = 0.1):
    """The norm of ``x`` split at ``k`` (None: one group) with the batch
    statistics of its :func:`moments` buffer ``stats``; ``scale`` and
    ``bias`` float32 [C], one affine for both groups; ``ema``: the running
    (mean, var) of group 0 and, with two groups, of group 1 (the same pair
    for both: group 1 goes first), or None."""
    return _Normalize.apply(x, scale, bias, stats, None, k, eps, ema, momentum)


def normalize_fixed(x, mean, var, scale, bias, eps: float):
    """The norm of ``x`` with the given float32 [C] mean and biased variance
    (constants: no gradient reaches them)."""
    if torch.is_grad_enabled() and (mean.requires_grad or var.requires_grad):
        raise ValueError("the norm kernel takes constant statistics here; batch statistics "
                         "go through moments() and normalize()")
    return _Normalize.apply(x, scale, bias, mean, var, None, eps, None, 0.0)
