"""Fused MC mask-head epilogue: BN apply (batch moments given) + ReLU +
dropout + 1x1 conv 305 -> 2, over three row views x_up[256] | ll[48] |
boundary[1] whose 305-channel concat never exists.

Replaces the TPU kernel ``uda_clr_tpu/ops/pallas/mask_head.py:_kernel_split``
(entry ``fused_mask_head_split``). On a CUDA tensor the wrapper launches the
hand-written kernel ``csrc/mask_head.cu`` or raises; there is no fallback.
On a CPU tensor it runs :func:`mask_head_plain`, the plain PyTorch version
with the same rounding points and the same Philox4x32-10 dropout stream, so
the two agree elementwise at any rate.

The kernel's least time is set by bytes: it reads each input once (~640 MB
at the flagship shape in bf16, ~0.19 ms on an H100) and writes [M, 2]. This
first version runs well above that, held back by the integer work of its
Philox draws (same time in float32 as in bf16); see the source for its
design and PERF.md for its times.
Built with ``nvcc`` for sm_90a into ``build/kernels/`` at first use and
bound through a plain C entry point with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

C_X, C_L, C_ALL = 256, 48, 305
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "mask_head.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# Launches of the CUDA kernel; a run can show the main path went through it.
LAUNCHES = 0

_lib = None
build_log = ""

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product a*c, in int64 without
    overflow (c holds 32-bit words)."""
    p1 = c * (a & 0xFFFF)  # < 2^48
    p2 = c * (a >> 16)  # < 2^48
    s = ((p2 & 0xFFFF) << 16) + p1
    return (p2 >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(ctr_lo: torch.Tensor, ctr_hi: torch.Tensor, seed: int):
    """Philox4x32-10 at counters (ctr_lo, ctr_hi, 0, 0), key = 64-bit seed;
    returns the four output words as int64 tensors."""
    c0, c1 = ctr_lo, ctr_hi
    c2 = c3 = torch.zeros_like(ctr_lo)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for i in range(10):
        if i:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(m: int, seed: int, device, rows_per_chunk: int = 1 << 15) -> torch.Tensor:
    """The kernel's random word for every element, int64 [m, 305]: word
    (e & 3) of Philox at counter e >> 2, e = row * 305 + channel."""
    out = torch.empty((m, C_ALL), dtype=torch.int64, device=device)
    flat = out.view(-1)
    for r0 in range(0, m, rows_per_chunk):
        e0, e1 = r0 * C_ALL, min(m, r0 + rows_per_chunk) * C_ALL
        g = torch.arange(e0 >> 2, ((e1 - 1) >> 2) + 1, device=device, dtype=torch.int64)
        words = torch.stack(philox4x32_10(g & _MASK32, g >> 32, seed), dim=1).view(-1)
        start = e0 - 4 * (e0 >> 2)
        flat[e0:e1] = words[start:start + (e1 - e0)]
    return out


def keep_threshold(rate: float) -> int:
    """A draw is kept when it is < floor(keep * 2^32)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return int((1.0 - rate) * 2.0**32)


def _inv_keep(rate: float) -> float:
    """1/keep as the float32 both versions multiply by."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def _coefficients(mean, var, scale, bias, w, w_bias, dt, eps):
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
    coef = _coefficients(mean, var, scale, bias, w, w_bias, dt, eps)
    mu, a, beta, w0, w1 = (coef[i * C_ALL:(i + 1) * C_ALL] for i in range(5))
    xf = torch.cat([x_up, ll, boundary], dim=-1).reshape(-1, C_ALL)
    h = torch.relu((xf - mu.to(dt)) * a.to(dt) + beta.to(dt))
    if rate > 0.0:
        if bits is None:
            bits = philox_bits(xf.shape[0], seed, xf.device)
        h = torch.where(bits < keep_threshold(rate), (h.float() * _inv_keep(rate)).to(dt),
                        torch.zeros((), dtype=dt, device=h.device))
    out = h.float() @ torch.stack([w0, w1], dim=1) + coef[5 * C_ALL:]
    return out.to(dt).reshape(*lead, 2)


def _load():
    """Build (once per source digest) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    so = BUILD_DIR / f"libuda_mask_head_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE}:\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.uda_mask_head_split
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def build() -> str:
    """Compile and load the kernel now; returns nvcc's log (empty when the
    library for this source was already built)."""
    _load()
    return build_log


def _check_cuda_inputs(x_up, ll, boundary):
    lead = x_up.shape[:-1]
    for t, c, name in ((x_up, C_X, "x_up"), (ll, C_L, "ll"), (boundary, 1, "boundary")):
        if not t.is_cuda or t.device != x_up.device:
            raise ValueError(f"{name} must be on {x_up.device}, got {t.device}")
        if t.dtype != x_up.dtype or t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes one of float32/bfloat16")
        if t.shape[:-1] != lead or t.shape[-1] != c:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(lead) + (c,)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous row-major [..., {c}] "
                             "(a channels_last NCHW tensor's NHWC view)")
    for t, name in ((x_up, "x_up"), (ll, "ll")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def fused_mask_head_split(x_up, ll, boundary, mean, var, scale, bias, w, w_bias,
                          seed: int, rate: float = 0.1, eps: float = 1e-5):
    """x_up [..., 256], ll [..., 48], boundary [..., 1] (NHWC rows), the
    305-channel batch ``mean``/``var``, BN ``scale``/``bias`` [305], conv
    weight ``w`` [2, 305, 1, 1] and bias [2]; dropout at ``rate`` from the
    64-bit ``seed``. Returns [..., 2] in the input dtype."""
    if not x_up.is_cuda:
        return mask_head_plain(x_up, ll, boundary, mean, var, scale, bias, w, w_bias,
                               seed, rate, eps)
    global LAUNCHES
    _check_cuda_inputs(x_up, ll, boundary)
    threshold = keep_threshold(rate)
    lib = _load()
    dt = x_up.dtype
    coef = _coefficients(mean, var, scale, bias, w, w_bias, dt, eps).to(x_up.device)
    out = torch.empty(x_up.shape[:-1] + (2,), dtype=dt, device=x_up.device)
    m = out.numel() // 2
    err = lib.uda_mask_head_split(
        x_up.data_ptr(), ll.data_ptr(), boundary.data_ptr(), coef.data_ptr(), out.data_ptr(),
        m, seed & 0xFFFFFFFFFFFFFFFF, min(threshold, _MASK32), _inv_keep(rate) if rate else 1.0,
        int(rate > 0.0), int(dt == torch.bfloat16), x_up.device.index,
        torch.cuda.current_stream(x_up.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mask-head kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
