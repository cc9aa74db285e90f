"""Domain-aware batch normalization (uda_clr_tpu/models/norm.py): plain BN
(``'bn'``, :46-73,212-251) and TransNorm (``'tn'``, :103-210).

* Moments are reduced in float32 as E[x^2] - E[x]^2 (biased), clamped at
  >= 0 — not ``torch.var``.
* The normalize runs in the activation dtype, exactly ``_normalize``.
* ``domains=2`` treats the batch as [source; target] halves, each with its
  own moments; running stats then update target half first, source second.
* Running stats use the unbiased factor n/(n-1) and momentum 0.1, and are
  written in place on every train-mode call.
* Under data parallelism the moments are those of the global batch: each
  norm site all-sums its packed float32 [sum x, sum x^2, count] over the
  ranks in one collective (TransNorm's two halves share it), and ``n`` is
  the global count (every rank holds an equal shard). On the ``('data',
  'space')`` mesh the stripes are shards too, so the same sums give the
  global moments; there ``n`` is the all-summed count, since a stripe may
  hold the image's padding rows (MobileNet's expansion) and the shards
  need not be equal.

TransNorm keeps per-domain running stats with a shared affine, and scales
each channel by the detached transferability factor ``a1 = 1 + C p / sum(p)``,
``p = 1 / (1 + |mu_s / sigma_s - mu_t / sigma_t|)`` (sigma from the
*unbiased* variance), folded into the affine as scale * a1 and bias * a1:

* train mode always splits the batch into [source; target] halves, whatever
  ``domains`` says (an odd batch splits unevenly, source first). JAX halves
  the global batch. Under data parallelism the S||T batch ([S_r; T_r]) and
  the slow MC pass's [T_r; T_r] hold a shard of each global half in their
  local halves; a batch of one domain is sharded by rows, so the step
  names this rank's rows of it (:func:`global_rows`) and each local row
  goes to the half its global index lies in;
* ``domains=0`` is the MC pass's degenerate mode: the batch stands for an
  identical-halves [T; T] repeat, for which a1 == 2 exactly, so the layer
  normalizes with its own batch moments times 2 and writes no stats;
* eval mode normalizes with the target running stats, a1 from the running
  stats.

On a CUDA tensor every path runs the hand-written kernel K4
(ops/domain_norm.py): one moments and one normalize launch a site forward
(the EMA in the normalize's epilogue), a reduce and a dx launch backward;
TransNorm's ``a1`` is one more small launch from the moments; the affine's
``scale * a1``, ``bias * a1`` and ``domains=0``'s x2 stay C-sized torch
ops in front of the normalize, so autograd carries their gradients. The
op-by-op code here is the kernel's plain version, which CPU tensors take.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn

from uda_clr_tpu_torch.ops import domain_norm as K4
from uda_clr_tpu_torch.parallel import spatial
from uda_clr_tpu_torch.parallel.distributed import world_size
from uda_clr_tpu_torch.parallel.reduce import all_sum


# (the global indices of the local rows, the global batch size) of the
# one-domain batch in the forward running now, or None (:func:`global_rows`)
_ROWS: tuple[tuple[int, ...], int] | None = None


@contextlib.contextmanager
def global_rows(rows: tuple[tuple[int, ...], int] | None):
    """Within the block, TransNorm's train-mode forwards under data
    parallelism take local row ``i`` of their batch as row ``index[i]`` of a
    global batch of ``total`` (``rows = (index, total)``, ``index``
    ascending) and split that global batch into its [source; target] halves
    (``None``: the local halves are shards of the global ones, as in the
    S||T and [T; T] batches). One process ignores it."""
    global _ROWS
    before, _ROWS = _ROWS, None if rows is None else (tuple(rows[0]), rows[1])
    try:
        yield
    finally:
        _ROWS = before


def current_rows() -> tuple[tuple[int, ...], int] | None:
    """The layout :func:`global_rows` set (for a recompute to restore, or a
    layer that hands a norm a subset of the rows)."""
    return _ROWS


def _moments(xs, dims,
             equal_shards: bool = True) -> list[tuple[torch.Tensor, torch.Tensor, object]]:
    """float32 mean, biased variance and count ``n`` of each tensor in
    ``xs`` over ``dims``, over the global batch: under data parallelism one
    packed ``all_sum`` of every part's [sum x, sum x^2] and its count. ``n``
    is a Python int (the local count times the world size: equal shards),
    except under the spatial mesh or with ``equal_shards`` False, where it
    is the all-summed count (a 0-d tensor): a stripe may carry the image's
    padding rows (MobileNet's expansion), and a rank may hold more rows of
    one half of a one-domain batch than another rank does."""
    if world_size() == 1:
        out = []
        for x in xs:
            x32 = x.float()
            mean = x32.mean(dims)
            out.append((mean, torch.clamp((x32 * x32).mean(dims) - mean * mean, min=0.0),
                        math.prod(x.shape[d] for d in dims)))
        return out
    sums, shapes, counts = [], [], []
    for x in xs:
        x32 = x.float()
        s1, s2 = x32.sum(dims), (x32 * x32).sum(dims)
        sums += [s1.reshape(-1), s2.reshape(-1)]
        shapes.append(s1.shape)
        counts.append(math.prod(x.shape[d] for d in dims))
    packed = all_sum(torch.cat(sums + [sums[0].new_tensor(counts)]))
    n = packed[-len(xs):]
    out, offset = [], 0
    for i, shape in enumerate(shapes):
        size = math.prod(shape)
        mean = packed[offset:offset + size].reshape(shape) / n[i]
        ex2 = packed[offset + size:offset + 2 * size].reshape(shape) / n[i]
        count = n[i].detach() if spatial.active() or not equal_shards \
            else counts[i] * world_size()
        out.append((mean, torch.clamp(ex2 - mean * mean, min=0.0), count))
        offset += 2 * size
    return out


def batch_moments_parts(xs, dims) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """float32 mean and biased variance of each tensor in ``xs`` over
    ``dims``, over the global batch (:func:`_moments`; on CUDA 4-D tensors
    reduced over all but one dimension, K4's moments, that dimension taken
    as the channels)."""
    if K4.launches_on(xs[0]):
        reduced = sorted(d % 4 for d in dims)
        if xs[0].dim() != 4 or len(dims) != 3 or len(set(reduced)) != 3:
            raise ValueError(f"the norm kernel reduces a 4-D tensor over three dimensions, "
                             f"not {tuple(dims)} of {xs[0].dim()}")
        # the kept dimension second, as the kernel's channels
        (keep,) = set(range(4)) - set(reduced)
        xs = [x.permute(reduced[0], keep, *reduced[1:]) for x in xs]
        out = []
        for x, stats in zip(xs, K4.moments([(x, None) for x in xs])):
            mean, var, _ = K4.mean_var(stats, 1, x.shape[1])
            out.append((mean[0], var[0]))
        return out
    return [(mean, var) for mean, var, _ in _moments(xs, dims)]


def batch_moments(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 mean and biased variance over ``dims`` (of the global batch
    under data parallelism)."""
    return batch_moments_parts([x], dims)[0]


def _unbias(n):
    """n / (n - 1), the running variance's factor, for a count that is an
    int or a 0-d tensor."""
    return n / (n - 1).clamp(min=1) if torch.is_tensor(n) else n / max(n - 1, 1)


def normalize(x, mean, var, scale, bias, eps: float = 1e-5):
    """:func:`normalize_plain`; on a CUDA [N, C, H, W] tensor with [C]
    vectors, K4's normalize with the statistics as constants."""
    if K4.launches_on(x):
        return K4.normalize_fixed(x, mean, var, scale, bias, eps)
    return normalize_plain(x, mean, var, scale, bias, eps)


def normalize_plain(x, mean, var, scale, bias, eps: float = 1e-5):
    """``(x - mean) * (rsqrt(var+eps)*scale) + bias`` in x.dtype; the
    [..., C] vectors broadcast over NCHW."""
    dt = x.dtype
    shape = mean.shape[:-1] + (mean.shape[-1], 1, 1)
    inv = torch.rsqrt(var + eps)
    return (x - mean.reshape(shape).to(dt)) * (inv * scale).reshape(shape).to(dt) \
        + bias.reshape(bias.shape[:-1] + (-1, 1, 1)).to(dt)


def transfer_factor(mean_s, var_s, mean_t, var_t, eps: float) -> torch.Tensor:
    """TransNorm's detached per-channel ``1 + alpha`` from two domains'
    means and (unbiased) variances."""
    dis = torch.abs(mean_s * torch.rsqrt(var_s + eps) - mean_t * torch.rsqrt(var_t + eps))
    prob = 1.0 / (1.0 + dis)
    return (1.0 + mean_s.shape[-1] * prob / torch.sum(prob)).detach()


class DomainNorm2d(nn.Module):
    """BatchNorm2d (``mode='bn'``) with an optional source||target split
    (``domains=2``), or TransNorm (``mode='tn'``).

    State-dict keys are the reference's: ``weight``, ``bias`` and
    ``running_mean``/``running_var`` (``nn.BatchNorm2d``), or for TransNorm
    ``running_{mean,var}_{source,target}`` (sync_batchnorm/batchnorm.py
    :313-317). ``domains`` 0 and 1 are the same for plain BN.
    """

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1,
                 mode: str = "bn"):
        super().__init__()
        if mode not in ("bn", "tn"):
            raise ValueError(f"norm mode {mode!r}; 'bn' or 'tn'")
        self.mode = mode
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        if mode == "bn":
            self.register_buffer("running_mean", torch.zeros(features))
            self.register_buffer("running_var", torch.ones(features))
        else:
            for dom in ("source", "target"):
                self.register_buffer(f"running_mean_{dom}", torch.zeros(features))
            for dom in ("source", "target"):
                self.register_buffer(f"running_var_{dom}", torch.ones(features))

    # False inside :func:`frozen_stats`: train-mode forwards then write no
    # running stats (the JAX package's ``mutable=False`` applies)
    update_stats = True

    @torch.no_grad()
    def _ema(self, mean, var, n: int, domain: str = ""):
        """EMA of the running stats (``domain`` 'source'/'target' for TN)
        toward a batch mean and biased variance over ``n`` values (the
        global count under data parallelism)."""
        if not self.update_stats:
            return
        m = self.momentum
        unbias = _unbias(n)
        r_mean, r_var = self._running(domain)
        r_mean.copy_((1.0 - m) * r_mean + m * mean)
        r_var.copy_((1.0 - m) * r_var + m * (var * unbias))

    def _forward_tn(self, x: torch.Tensor, train: bool, domains: int) -> torch.Tensor:
        scale, bias, eps = self.weight, self.bias, self.eps
        if not train:
            a1 = transfer_factor(self.running_mean_source, self.running_var_source,
                                 self.running_mean_target, self.running_var_target, eps)
            return normalize_plain(x, self.running_mean_target, self.running_var_target,
                                   scale * a1, bias * a1, eps)
        if domains == 0:
            mu, v, _ = _moments([x], (0, 2, 3))[0]
            return normalize_plain(x, mu, v, scale * 2.0, bias * 2.0, eps)
        k = self._tn_split(x)
        if k is not None:
            return self._forward_tn_split(x, k)
        b = x.shape[0] // 2
        x2 = x.unflatten(0, (2, b))  # [2, b, C, H, W]
        mu2, v2, n = _moments([x2], (1, 3, 4))[0]  # [2, C]; n per half, global
        self._ema(mu2[0].detach(), v2[0].detach(), n, "source")
        self._ema(mu2[1].detach(), v2[1].detach(), n, "target")
        vu = v2.detach() * _unbias(n)
        a1 = transfer_factor(mu2[0].detach(), vu[0], mu2[1].detach(), vu[1], eps)
        z = normalize_plain(x2, mu2[:, None, :], v2[:, None, :], (scale * a1).expand(2, 1, -1),
                            bias * a1, eps)
        return z.flatten(0, 1)

    def _forward_tn_split(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """Train-mode TransNorm with the local rows ``[:k]`` in the source
        half and ``[k:]`` in the target half, each half's moments and count
        over the global batch, its own unbiased factor in ``a1``."""
        scale, bias, eps = self.weight, self.bias, self.eps
        halves = (x[:k], x[k:])
        moments = _moments(halves, (0, 2, 3), equal_shards=False)
        for (mu, v, n), dom in zip(moments, ("source", "target")):
            self._ema(mu.detach(), v.detach(), n, dom)
        (mu_s, v_s, n_s), (mu_t, v_t, n_t) = moments
        a1 = transfer_factor(mu_s.detach(), v_s.detach() * _unbias(n_s),
                             mu_t.detach(), v_t.detach() * _unbias(n_t), eps)
        return torch.cat([normalize_plain(h, mu, v, scale * a1, bias * a1, eps)
                          for h, (mu, v, _) in zip(halves, moments)], dim=0)

    @staticmethod
    def _tn_split(x: torch.Tensor) -> int | None:
        """Train-mode TransNorm's uneven split of ``x``'s rows, or None for
        the even halves."""
        if _ROWS is not None and world_size() > 1:
            # a shard of a one-domain batch: the rows before the global
            # batch's middle are source, the others target
            index, total = _ROWS
            if len(index) != x.shape[0]:
                raise ValueError(f"TransNorm: a layout of {len(index)} rows for a batch of "
                                 f"{x.shape[0]}")
            return sum(i < total // 2 for i in index)
        if x.shape[0] % 2:
            # the reference's uneven b//2 split (batchnorm.py:439-442)
            return x.shape[0] // 2
        return None

    def _running(self, domain: str = "") -> tuple[torch.Tensor, torch.Tensor]:
        """The running (mean, var) buffers (``domain`` 'source'/'target'
        for TN)."""
        sfx = f"_{domain}" if domain else ""
        return getattr(self, "running_mean" + sfx), getattr(self, "running_var" + sfx)

    def _forward_kernel(self, x: torch.Tensor, train: bool, domains: int) -> torch.Tensor:
        """Every mode of :meth:`forward_plain` through K4: the same
        statistics, splits, EMA order and affine."""
        scale, bias, eps = self.weight, self.bias, self.eps
        if self.mode == "bn":
            if not train:
                return K4.normalize_fixed(x, self.running_mean, self.running_var, scale, bias, eps)
            k = None
            if domains > 1:
                if x.shape[0] % 2:
                    raise ValueError(f"domains=2 splits an even batch, got {x.shape[0]}")
                k = x.shape[0] // 2
            stats = K4.moments([(x, k)])[0]
            # two halves write the one pair of buffers: the target half first
            ema = [self._running()] * (1 if k is None else 2) if self.update_stats else None
            return K4.normalize(x, stats, k, scale, bias, eps, ema, self.momentum)
        if not train:
            a1 = transfer_factor(*self._running("source"), *self._running("target"), eps)
            return K4.normalize_fixed(x, *self._running("target"), scale * a1, bias * a1, eps)
        if domains == 0:
            stats = K4.moments([(x, None)])[0]
            return K4.normalize(x, stats, None, scale * 2.0, bias * 2.0, eps)
        k = self._tn_split(x)
        k = x.shape[0] // 2 if k is None else k
        stats = K4.moments([(x, k)])[0]
        a1 = K4.tn_factor(stats, x.shape[1], eps)
        ema = [self._running("source"), self._running("target")] if self.update_stats else None
        return K4.normalize(x, stats, k, scale * a1, bias * a1, eps, ema, self.momentum)

    def forward(self, x: torch.Tensor, train: bool, domains: int = 1) -> torch.Tensor:
        if K4.launches_on(x):
            return self._forward_kernel(x, train, domains)
        return self.forward_plain(x, train, domains)

    def forward_plain(self, x: torch.Tensor, train: bool, domains: int = 1) -> torch.Tensor:
        """The op-by-op norm (K4's plain version), on any device."""
        if self.mode == "tn":
            return self._forward_tn(x, train, domains)
        if not train:
            return normalize_plain(x, self.running_mean, self.running_var,
                                   self.weight, self.bias, self.eps)
        if domains <= 1:
            mu, v, n = _moments([x], (0, 2, 3))[0]
            self._ema(mu.detach(), v.detach(), n)
            return normalize_plain(x, mu, v, self.weight, self.bias, self.eps)
        b = x.shape[0] // 2
        x2 = x.unflatten(0, (2, b))  # [2, b, C, H, W]
        mu2, v2, n = _moments([x2], (1, 3, 4))[0]  # [2, C]; n per half, global
        self._ema(mu2[1].detach(), v2[1].detach(), n)
        self._ema(mu2[0].detach(), v2[0].detach(), n)
        scale = self.weight.expand(2, -1)
        z = normalize_plain(x2, mu2[:, None, :], v2[:, None, :], scale[:, None, :],
                            self.bias, self.eps)
        return z.flatten(0, 1)


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Within the block, train-mode forwards of ``module`` normalise with
    batch moments as usual but write no running stats."""
    norms = [m for m in module.modules() if isinstance(m, DomainNorm2d)]
    before = [m.update_stats for m in norms]  # restored as found, so the blocks nest
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m, flag in zip(norms, before):
            m.update_stats = flag
