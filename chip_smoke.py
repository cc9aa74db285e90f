#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (uda_clr_tpu_torch) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. builds the hand-written CUDA kernel of the flagship train step from the
   sources in the checkout (nvcc, sm_90a) and prints the card's name and
   power limit;
2. holds the kernel to its plain PyTorch version at the shape the flagship
   step gives it (M = 64*128*128 rows), in bfloat16 and float32, at dropout
   rate 0 and 0.1, elementwise (the plain version replays the kernel's
   Philox stream), and times both;
3. runs a small train step on the card and on the CPU from the same seed
   (float32, TF32 off, dropout off) and compares the losses;
4. drives the flagship ``prototype_full`` train step at full width
   (mobilenet DeepLabv3+ OS16, 512x512, 8 source + 8 target images, T=8 MC
   samples, bfloat16): one warmup step, then five prototype-phase steps,
   checking finite losses, moving prototype banks and one kernel launch per
   prototype-phase step;
5. prints a ``kernels`` JSON line, the card's name and power limit, and as
   its last line ``{"ok": true, "device": {...}}``.

It exits non-zero, with no result line, when there is no CUDA card, when
the port's package is not beside it, or when any phase fails. float32
comparisons run with TF32 off (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` both False) for the whole run.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

MAIN_SHAPE = (64, 128, 128)  # T*B rows of the MC pass at 512^2, B=8, T=8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
KERNEL_WINDOWS, KERNEL_PER_WINDOW = 5, 20
PLAIN_WINDOWS = 5
PROTO_STEPS = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, windows: int, per_window: int) -> float:
    """Median over ``windows`` of the mean time of ``per_window``
    back-to-back calls, each window timed with CUDA events."""
    import torch

    fn()  # warm
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_window):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_window)
    return statistics.median(times)


def kernel_phase(torch, mh, batch_moments, kernel_seed):
    """Kernel vs plain version at the main path's shape; returns the
    bfloat16 rate-0.1 numbers (the main path's dtype and rate)."""
    n, h, w = MAIN_SHAPE
    m = n * h * w
    g = torch.Generator("cuda").manual_seed(0)
    rand = lambda *s: torch.randn(*s, device="cuda", generator=g)
    scale, bias = 1.0 + 0.2 * rand(305), 0.1 * rand(305)
    wt, wb = 0.05 * rand(2, 305, 1, 1), 0.1 * rand(2)
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        x_up = rand(n, h, w, 256).to(dtype)
        ll = torch.relu(rand(n, h, w, 48)).to(dtype)
        bnd = rand(n, h, w, 1).to(dtype)
        moments = [batch_moments(t, (0, 1, 2)) for t in (x_up, ll, bnd)]
        mean = torch.cat([mu for mu, _ in moments])
        var = torch.cat([v for _, v in moments])
        args = (x_up, ll, bnd, mean, var, scale, bias, wt, wb)
        seed = kernel_seed(0, 0)
        for rate in (0.0, 0.1):
            got = mh.fused_mask_head_split(*args, seed=seed, rate=rate).float()
            want = mh.mask_head_plain(*args, seed=seed, rate=rate).float()
            torch.cuda.synchronize()
            if got.shape != (n, h, w, 2) or not bool(torch.isfinite(got).all()):
                fail(f"kernel output {tuple(got.shape)} {dtype} rate {rate} is not finite")
            peak = float(want.abs().max())
            # float32: the sums over 305 channels run in another order;
            # bfloat16: the same, then rounding may land one ulp apart
            tol = 1e-5 * max(1.0, peak) if dtype == torch.float32 else peak * 2.0**-7
            err = float((got - want).abs().max())
            name = f"{str(dtype).split('.')[-1]} rate {rate}"
            say(f"kernel vs plain, {name}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
            if not err <= tol:
                fail(f"kernel disagrees with its plain version ({name})")
            if rate:
                # ~30 of a row's 305 channels drop, so almost every output moves
                same = float((got == mh.mask_head_plain(*args, seed=seed, rate=0.0)
                              .float()).float().mean())
                say(f"  share of outputs equal to the rate-0 outputs: {same:.4f}")
                if same > 0.05:
                    fail("dropout at rate 0.1 left the outputs unchanged")
        ms = cuda_ms(lambda: mh.fused_mask_head_split(*args, seed=seed, rate=0.1),
                     KERNEL_WINDOWS, KERNEL_PER_WINDOW)
        plain_ms = cuda_ms(lambda: mh.mask_head_plain(*args, seed=seed, rate=0.1),
                           PLAIN_WINDOWS, 1)
        itemsize = x_up.element_size()
        bytes_moved = m * 305 * itemsize + m * 2 * itemsize
        bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        say(f"kernel {str(dtype).split('.')[-1]} rate 0.1: {ms:.4f} ms per launch (median of "
            f"{KERNEL_WINDOWS} windows of {KERNEL_PER_WINDOW}), plain {plain_ms:.3f} ms, "
            f"byte bound {bound_ms:.4f} ms ({bytes_moved / 1e6:.1f} MB)")
        if dtype == torch.bfloat16:
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        del x_up, ll, bnd, args, got, want
    torch.cuda.empty_cache()
    return result


def small_parity_phase(torch, np, ports):
    """The port's train step on the card (kernel path) and on the CPU
    (plain versions), same seed, dropout off, float32: warmup then one
    prototype-phase step."""
    Config, create_train_state, make_train_step, layers = ports
    rng = np.random.default_rng(1)
    b, size = 2, 64
    arrs = {
        "image_s": rng.standard_normal((b, size, size, 3)).astype(np.float32),
        "map_s": (rng.uniform(0, 1, (b, size, size, 2)) > 0.5).astype(np.float32),
        "boundary_s": rng.uniform(0, 1, (b, size, size, 1)).astype(np.float32),
        "image_t": rng.standard_normal((b, size, size, 3)).astype(np.float32),
    }
    cfg = Config()
    cfg.method.mc_samples = 4
    losses = {}
    layers.set_dropout_off(True)
    try:
        for device in ("cpu", "cuda"):
            state = create_train_state(cfg, seed=3, device=device)
            batch = {k: torch.from_numpy(v).to(device) for k, v in arrs.items()}
            out = []
            for proto in (False, True):
                state, m = make_train_step(cfg, "prototype_full", proto)(state, batch, 1e-5, 2.5e-5)
                out.append({k: float(v) for k, v in m.items()})
            losses[device] = out
    finally:
        layers.set_dropout_off(False)
    # step 0: float32 noise of cuDNN vs CPU convolutions; step 1 inherits
    # Adam's first update, whose sign is noise where a gradient is ~0
    for i, rtol in enumerate((1e-3, 2e-2)):
        for k, want in losses["cpu"][i].items():
            got = losses["cuda"][i][k]
            rel = abs(got - want) / max(abs(want), 1e-12)
            say(f"small step {i} {k}: card {got:.6g} cpu {want:.6g} rel {rel:.2e} (tolerance {rtol:g})")
            if not rel <= rtol:
                fail(f"small step {i}: {k} disagrees between the card and the CPU")


def slice_phase(torch, np, ports, mh):
    """The flagship train step at full width; returns its numbers."""
    Config, create_train_state, make_train_step, _ = ports
    b, size = 8, 512
    cfg = Config()
    cfg.model.compute_dtype = "bfloat16"
    cfg.method.mc_samples = 8
    rng = np.random.default_rng(0)
    arrs = {
        "image_s": rng.standard_normal((b, size, size, 3)).astype(np.float32),
        "map_s": (rng.uniform(0, 1, (b, size, size, 2)) > 0.5).astype(np.float32),
        "boundary_s": rng.uniform(0, 1, (b, size, size, 1)).astype(np.float32),
        "image_t": rng.standard_normal((b, size, size, 3)).astype(np.float32),
    }
    batch = {k: torch.from_numpy(v).cuda() for k, v in arrs.items()}  # staged once
    state = create_train_state(cfg, seed=0, device="cuda")
    warm = make_train_step(cfg, "prototype_full", proto_phase=False)
    proto = make_train_step(cfg, "prototype_full", proto_phase=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    mh.LAUNCHES = 0  # counts from here on are the main path's
    t0 = time.perf_counter()
    state, m = warm(state, batch, 1e-3, 2.5e-5)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    check_metrics(m, "warmup")
    if mh.LAUNCHES != 0:
        fail(f"the warmup step launched the mask-head kernel {mh.LAUNCHES} times")
    say(f"warmup step: {warm_ms:.1f} ms (first step), {fmt(m)}")

    banks = []
    step_ms = []
    for i in range(PROTO_STEPS):
        t0 = time.perf_counter()
        state, m = proto(state, batch, 1e-3, 2.5e-5)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check_metrics(m, f"prototype step {i}")
        if mh.LAUNCHES != i + 1:
            fail(f"after {i + 1} prototype-phase steps the kernel ran {mh.LAUNCHES} times")
        banks.append(torch.cat([state.proto_src, state.proto_trg]).clone())
        say(f"prototype step {i}: {step_ms[-1]:.1f} ms, {fmt(m)}")
    launches = mh.LAUNCHES
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    if not (bool(state.proto_src_init) and bool(state.proto_trg_init)):
        fail("the prototype banks were never seeded")
    for i, bank in enumerate(banks):
        if not bool(torch.isfinite(bank).all()) or float(bank.abs().max()) == 0.0:
            fail(f"prototype bank after step {i} is zero or not finite")
        if i and torch.equal(bank, banks[i - 1]):
            fail(f"prototype step {i} left the banks unchanged")
    # the first prototype-phase step includes the MC pass's first-call costs
    med = statistics.median(step_ms[1:])
    say(f"flagship prototype step: median {med:.2f} ms over steps 1-{PROTO_STEPS - 1}, "
        f"{b / (med / 1e3):.2f} img/s (source images per second), "
        f"peak memory {peak_gib:.2f} GiB, mask-head launches {launches}")
    return launches


def check_metrics(m: dict, where: str) -> None:
    for k, v in m.items():
        if v.dim() != 0 or not math.isfinite(float(v)):
            fail(f"{where}: {k} = {v} is not a finite scalar")


def fmt(m: dict) -> str:
    return ", ".join(f"{k} {float(v):.5g}" for k, v in m.items())


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke run needs a CUDA card")
    try:
        import numpy as np

        from uda_clr_tpu_torch.config import Config
        from uda_clr_tpu_torch.models import layers
        from uda_clr_tpu_torch.models.norm import batch_moments
        from uda_clr_tpu_torch.ops import mask_head as mh
        from uda_clr_tpu_torch.train.state import create_train_state
        from uda_clr_tpu_torch.train.steps import kernel_seed, make_train_step
    except ImportError as e:
        fail(f"the port's package is not importable from here ({e}); run from the repo root")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ports = (Config, create_train_state, make_train_step, layers)

    card = card_line()
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    log = mh.build()
    say(f"build: {time.perf_counter() - t0:.1f} s, {mh.SOURCE.name} with nvcc for sm_90a")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

    numbers = kernel_phase(torch, mh, batch_moments, kernel_seed)
    small_parity_phase(torch, np, ports)
    launches = slice_phase(torch, np, ports, mh)

    kernels = [{
        "name": "mask_head_split",
        "route": "cuda",
        "source": "uda_clr_tpu_torch/csrc/mask_head.cu",
        "replaces": "uda_clr_tpu/ops/pallas/mask_head.py:154",
        "launches": launches,
        "max_abs_err": numbers["max_abs_err"],
        "ms": numbers["ms"],
        "plain_ms": numbers["plain_ms"],
        "bound_ms": numbers["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes this function
    }]
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
