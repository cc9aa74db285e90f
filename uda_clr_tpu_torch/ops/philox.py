"""Philox4x32-10 in int64 tensor arithmetic: the stream the port's CUDA
kernels draw their dropout masks from (csrc/philox.cuh), replayed by their
plain versions. Element e of a draw takes word (e & 3) of Philox at counter
(e >> 2, 0, 0, 0) under a 64-bit key; a draw keeps an element when its word
is < floor(keep * 2^32)."""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product a*c, in int64 without
    overflow (c holds 32-bit words)."""
    p1 = c * (a & 0xFFFF)  # < 2^48
    p2 = c * (a >> 16)  # < 2^48
    s = ((p2 & 0xFFFF) << 16) + p1
    return (p2 >> 16) + (s >> 32), s & MASK32


def philox4x32_10(ctr_lo: torch.Tensor, ctr_hi: torch.Tensor, seed: int):
    """Philox4x32-10 at counters (ctr_lo, ctr_hi, 0, 0), key = 64-bit seed;
    returns the four output words as int64 tensors."""
    c0, c1 = ctr_lo, ctr_hi
    c2 = c3 = torch.zeros_like(ctr_lo)
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    for i in range(10):
        if i:
            k0, k1 = (k0 + _PHILOX_W[0]) & MASK32, (k1 + _PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words(e0: int, e1: int, seed: int, device) -> torch.Tensor:
    """The words of elements e0 .. e1-1 of the stream, int64 [e1 - e0]."""
    g = torch.arange(e0 >> 2, ((e1 - 1) >> 2) + 1, device=device, dtype=torch.int64)
    words = torch.stack(philox4x32_10(g & MASK32, g >> 32, seed), dim=1).view(-1)
    start = e0 - 4 * (e0 >> 2)
    return words[start:start + (e1 - e0)]


def keep_threshold(rate: float) -> int:
    """A draw is kept when it is < floor(keep * 2^32)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return int((1.0 - rate) * 2.0**32)


def inv_keep(rate: float, dtype: torch.dtype) -> float:
    """1/keep rounded to ``dtype``: what the TPU kernels scale kept elements
    by (``jnp.asarray(1/keep, x.dtype)``)."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).to(dtype))


def splitmix64(z: int) -> int:
    """splitmix64's finaliser of a 64-bit integer (host arithmetic only)."""
    z = (z + 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)
