"""Domain-aware batch normalization, ``'bn'`` mode (uda_clr_tpu/models/norm.py
:46-73,212-251).

* Moments are reduced in float32 as E[x^2] - E[x]^2 (biased), clamped at
  >= 0 — not ``torch.var``.
* The normalize runs in the activation dtype, exactly ``_normalize``.
* ``domains=2`` treats the batch as [source; target] halves, each with its
  own moments; running stats then update target half first, source second.
* Running stats use the unbiased factor n/(n-1) and momentum 0.1, and are
  written in place on every train-mode call.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn


def batch_moments(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 mean and biased variance over ``dims``."""
    x32 = x.float()
    mean = x32.mean(dims)
    var = torch.clamp((x32 * x32).mean(dims) - mean * mean, min=0.0)
    return mean, var


def normalize(x, mean, var, scale, bias, eps: float = 1e-5):
    """``(x - mean) * (rsqrt(var+eps)*scale) + bias`` in x.dtype; the
    [..., C] vectors broadcast over NCHW."""
    dt = x.dtype
    shape = mean.shape[:-1] + (mean.shape[-1], 1, 1)
    inv = torch.rsqrt(var + eps)
    return (x - mean.reshape(shape).to(dt)) * (inv * scale).reshape(shape).to(dt) \
        + bias.reshape(bias.shape[:-1] + (-1, 1, 1)).to(dt)


class DomainNorm2d(nn.Module):
    """BatchNorm2d with an optional source||target split (``domains=2``).

    State-dict keys are ``weight``, ``bias``, ``running_mean`` and
    ``running_var``, as the reference's ``nn.BatchNorm2d``. ``domains`` 0
    and 1 are the same for plain BN.
    """

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    # False inside :func:`frozen_stats`: train-mode forwards then write no
    # running stats (the JAX package's ``mutable=False`` applies)
    update_stats = True

    @torch.no_grad()
    def _ema(self, mean, var, n: int):
        if not self.update_stats:
            return
        m = self.momentum
        unbias = n / max(n - 1, 1)
        self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1.0 - m) * self.running_var + m * (var * unbias))

    def forward(self, x: torch.Tensor, train: bool, domains: int = 1) -> torch.Tensor:
        if not train:
            return normalize(x, self.running_mean, self.running_var,
                             self.weight, self.bias, self.eps)
        n_pix = x.shape[2] * x.shape[3]
        if domains <= 1:
            mu, v = batch_moments(x, (0, 2, 3))
            self._ema(mu.detach(), v.detach(), x.shape[0] * n_pix)
            return normalize(x, mu, v, self.weight, self.bias, self.eps)
        b = x.shape[0] // 2
        x2 = x.unflatten(0, (2, b))  # [2, b, C, H, W]
        mu2, v2 = batch_moments(x2, (1, 3, 4))  # [2, C]
        self._ema(mu2[1].detach(), v2[1].detach(), b * n_pix)
        self._ema(mu2[0].detach(), v2[0].detach(), b * n_pix)
        scale = self.weight.expand(2, -1)
        z = normalize(x2, mu2[:, None, :], v2[:, None, :], scale[:, None, :],
                      self.bias, self.eps)
        return z.flatten(0, 1)


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Within the block, train-mode forwards of ``module`` normalise with
    batch moments as usual but write no running stats."""
    norms = [m for m in module.modules() if isinstance(m, DomainNorm2d)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True
