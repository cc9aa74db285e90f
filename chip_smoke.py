#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (uda_clr_tpu_torch) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. builds the port's hand-written CUDA kernels from the sources in the
   checkout (one nvcc per source, all at once, sm_90a) and prints the card's
   name and power limit;
2. holds each kernel to its plain PyTorch version, elementwise, at the
   shapes the train steps give it, and times kernel, plain version and (for
   dropout) the library call ``F.dropout``:
   K1, the MC mask head over three row views (M = 64*128*128 rows, bf16 and
   float32, rate 0 and 0.1); K2, the two-input mask head at the same M, also
   against K1 on the same rows; each timed alone (coefficients computed
   once) and through its wrapper, with its achieved bandwidth, share of the
   byte bound, shared memory per block and blocks per SM; K3, the fused dropout, forward and backward
   (channels_last input, NCHW-contiguous gradient) at the four dropout
   sites of the S||T forward at 512^2, B 8+8, in bf16, and at one float32
   shape;
3. runs small train steps on the card and on the CPU from the same seed
   (float32, TF32 off, dropout off) and compares their metrics:
   ``prototype_full`` (warmup, then a prototype-phase step) and
   ``prototype_mt`` (a prototype-phase step, then warmup);
4. drives the flagship ``prototype_full`` step at full width (mobilenet
   DeepLabv3+ OS16, 512x512, 8 source + 8 target images, T=8 MC samples,
   bfloat16): one warmup step, then five prototype-phase steps, checking
   finite losses, moving prototype banks and one K1 launch per
   prototype-phase step;
5. drives ``prototype_mt`` at the same width under the fused dropout kernel
   (``set_dropout_impl('pallas')``): one warmup step, then five
   prototype-phase steps, asserting K1 and K3's launches per step;
6. runs ``baseline``, ``adversarial``, ``posal`` and ``mean_teacher`` for
   two full-width steps each under the default dropout backend;
7. prints a ``kernels`` JSON line, the card's name and power limit, and as
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
# the dropout sites of one S||T forward at 512^2, B 8+8 (NCHW shape, rate):
# ASPP, boundary head 1 and 2, mask head
K3_SITES = (((16, 256, 32, 32), 0.5), ((16, 256, 128, 128), 0.5),
            ((16, 256, 128, 128), 0.1), ((16, 305, 128, 128), 0.1))
K3_F32_SITE = ((16, 256, 128, 128), 0.5)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
KERNEL_WINDOWS, KERNEL_PER_WINDOW = 5, 20
PLAIN_WINDOWS = 3
PROTO_STEPS = 5
# K3 launches of one train step under 'pallas': 4 model dropout sites per
# forward, one backward launch per site the loss reaches (all 4), and the
# augmented forward of prototype_mt (no backward with aug_backward off)
K3_SITES_PER_FORWARD = 4


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


def mask_head_inputs(torch, batch_moments, dtype, g):
    n, h, w = MAIN_SHAPE
    rand = lambda *s: torch.randn(*s, device="cuda", generator=g)
    x_up = rand(n, h, w, 256).to(dtype)
    ll = torch.relu(rand(n, h, w, 48)).to(dtype)
    bnd = rand(n, h, w, 1).to(dtype)
    moments = [batch_moments(t, (0, 1, 2)) for t in (x_up, ll, bnd)]
    mean = torch.cat([mu for mu, _ in moments])
    var = torch.cat([v for _, v in moments])
    return x_up, ll, bnd, mean, var


def mask_head_tolerance(torch, want, dtype) -> float:
    # float32: the sums over 305 channels run in another order; bfloat16:
    # the same, then rounding may land one ulp apart
    peak = float(want.abs().max())
    return 1e-5 * max(1.0, peak) if dtype == torch.float32 else peak * 2.0**-7


def kernel_phase(torch, mh, batch_moments, kernel_seed):
    """K1 and K2 against their plain version at the main path's shape, and
    K2 against K1 on the same rows; returns the bfloat16 rate-0.1 numbers
    (the main path's dtype and rate) of each."""
    m = math.prod(MAIN_SHAPE)
    g = torch.Generator("cuda").manual_seed(0)
    rand = lambda *s: torch.randn(*s, device="cuda", generator=g)
    scale, bias = 1.0 + 0.2 * rand(305), 0.1 * rand(305)
    wt, wb = 0.05 * rand(2, 305, 1, 1), 0.1 * rand(2)
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        x_up, ll, bnd, mean, var = mask_head_inputs(torch, batch_moments, dtype, g)
        x_bu = torch.cat([x_up, ll], dim=-1)
        tail = (scale, bias, wt, wb)
        args = (x_up, ll, bnd, mean, var) + tail
        args_bu = (x_bu, bnd, mean, var) + tail
        seed = kernel_seed(0, 0)
        dname = str(dtype).split(".")[-1]
        for rate in (0.0, 0.1):
            got = mh.fused_mask_head_split(*args, seed=seed, rate=rate)
            got_bu = mh.fused_mask_head(*args_bu, seed=seed, rate=rate)
            want = mh.mask_head_plain(*args, seed=seed, rate=rate).float()
            torch.cuda.synchronize()
            name = f"{dname} rate {rate}"
            for kname, out in (("K1", got), ("K2", got_bu)):
                if out.shape != MAIN_SHAPE + (2,) or not bool(torch.isfinite(out).all()):
                    fail(f"{kname} output {tuple(out.shape)} {name} is not finite")
            if not torch.equal(got, got_bu):
                fail(f"K2 on cat(x_up, ll) differs from K1 on the same rows ({name})")
            tol = mask_head_tolerance(torch, want, dtype)
            err = float((got.float() - want).abs().max())
            err_bu = float((got_bu.float() - want).abs().max())
            say(f"K1 vs plain, {name}: max_abs_err {err:.3e}; K2 vs plain {err_bu:.3e} "
                f"(tolerance {tol:.3e}); K2 == K1 elementwise")
            if not (err <= tol and err_bu <= tol):
                fail(f"a mask-head kernel disagrees with its plain version ({name})")
            if rate:
                # ~30 of a row's 305 channels drop, so almost every output moves
                same = float((got == mh.mask_head_plain(*args, seed=seed, rate=0.0)
                              .float()).float().mean())
                say(f"  share of outputs equal to the rate-0 outputs: {same:.4f}")
                if same > 0.05:
                    fail("dropout at rate 0.1 left the outputs unchanged")
        itemsize = x_up.element_size()
        bytes_moved = m * 305 * itemsize + m * 2 * itemsize
        bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        coef = mh.coefficients(mean, var, *tail, dtype)  # once, for the kernel-alone times
        for kname, views, fn, plain in (
                ("K1", (x_up, ll, bnd), lambda: mh.fused_mask_head_split(*args, seed=seed, rate=0.1),
                 lambda: mh.mask_head_plain(*args, seed=seed, rate=0.1)),
                ("K2", (x_bu, bnd), lambda: mh.fused_mask_head(*args_bu, seed=seed, rate=0.1),
                 lambda: mh.mask_head_bu_plain(*args_bu, seed=seed, rate=0.1))):
            ms = cuda_ms(lambda: mh.launch(views, coef, seed, 0.1), KERNEL_WINDOWS,
                         KERNEL_PER_WINDOW)
            wrapper_ms = cuda_ms(fn, KERNEL_WINDOWS, KERNEL_PER_WINDOW)
            plain_ms = cuda_ms(plain, PLAIN_WINDOWS, 1)
            smem, per_sm = mh.occupancy(kname == "K1", 0.1, dtype, "cuda")
            say(f"{kname} {dname} rate 0.1: kernel alone {ms:.4f} ms per launch (median of "
                f"{KERNEL_WINDOWS} windows of {KERNEL_PER_WINDOW}), {bytes_moved / ms / 1e6:.1f} "
                f"GB/s, {bound_ms / ms:.3f} of the byte bound {bound_ms:.4f} ms "
                f"({bytes_moved / 1e6:.1f} MB); wrapper with its coefficients {wrapper_ms:.4f} ms; "
                f"plain {plain_ms:.3f} ms; {smem} B dynamic shared memory per block, "
                f"{per_sm} blocks per SM")
            if dtype == torch.bfloat16:
                result[kname] = dict(max_abs_err=err if kname == "K1" else err_bu, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms)
        del x_up, ll, bnd, x_bu, args, args_bu, got, got_bu, want, coef
    torch.cuda.empty_cache()
    return result


def dropout_phase(torch, F, K3):
    """K3 forward and backward against its plain version, elementwise, at
    the four site shapes (bf16) and one float32 shape; returns the sums over
    the four bf16 sites (one S||T forward's worth) for forward and
    backward."""
    g = torch.Generator("cuda").manual_seed(1)
    totals = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
              for k in ("fwd", "bwd")}
    sites = [(shape, rate, torch.bfloat16) for shape, rate in K3_SITES]
    sites.append(K3_F32_SITE + (torch.float32,))
    for i, (shape, rate, dtype) in enumerate(sites):
        x = torch.randn(shape, device="cuda", generator=g).to(dtype)
        x = x.to(memory_format=torch.channels_last).requires_grad_()
        cot = torch.randn(shape, device="cuda", generator=g).to(dtype)  # NCHW-contiguous
        seed = 0x5EED0000 + i
        y = K3.fused_dropout(x, seed, rate)
        y.backward(cot)
        want = K3.dropout_plain(x.detach(), seed, rate)
        cot_cl = cot.contiguous(memory_format=torch.channels_last)
        want_grad = K3.dropout_plain(cot_cl, seed, rate)
        torch.cuda.synchronize()
        name = f"{list(shape)} {str(dtype).split('.')[-1]} rate {rate}"
        err = float((y.detach().float() - want.float()).abs().max())
        err_g = float((x.grad.float() - want_grad.float()).abs().max())
        kept = float((want != 0).float().mean())
        if not (torch.equal(y.detach(), want) and torch.equal(x.grad, want_grad)):
            fail(f"K3 disagrees with its plain version at {name} "
                 f"(forward {err:.3e}, backward {err_g:.3e})")
        if abs(kept - (1.0 - rate)) > 0.01:
            fail(f"K3 kept {kept:.4f} of the elements at {name}")
        xd = x.detach()
        ms = cuda_ms(lambda: K3.launch(xd, seed, rate), KERNEL_WINDOWS, KERNEL_PER_WINDOW)
        ms_g = cuda_ms(lambda: K3.launch(cot_cl, seed, rate), KERNEL_WINDOWS, KERNEL_PER_WINDOW)
        plain_ms = cuda_ms(lambda: K3.dropout_plain(xd, seed, rate), PLAIN_WINDOWS, 1)
        # the library's dropout: forward F.dropout; backward, the masked
        # scale of a stored mask (aten.native_dropout_backward)
        lib_ms = cuda_ms(lambda: F.dropout(xd, rate, training=True),
                         KERNEL_WINDOWS, KERNEL_PER_WINDOW)
        mask = want != 0
        lib_ms_g = cuda_ms(lambda: torch.ops.aten.native_dropout_backward(
            cot_cl, mask, 1.0 / (1.0 - rate)), KERNEL_WINDOWS, KERNEL_PER_WINDOW)
        bytes_moved = 2 * xd.numel() * xd.element_size()
        bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        say(f"K3 {name}: forward == plain and backward == plain elementwise, kept {kept:.4f}; "
            f"forward {ms:.4f} ms, backward {ms_g:.4f} ms, plain {plain_ms:.3f} ms, "
            f"F.dropout {lib_ms:.4f} ms, its backward {lib_ms_g:.4f} ms, byte bound {bound_ms:.4f} ms ({bytes_moved / 1e6:.1f} MB)")
        if dtype == torch.bfloat16:
            for key, t_ms, e, l_ms in (("fwd", ms, err, lib_ms), ("bwd", ms_g, err_g, lib_ms_g)):
                tot = totals[key]
                tot["max_abs_err"] = max(tot["max_abs_err"], e)
                tot["ms"] += t_ms
                tot["plain_ms"] += plain_ms
                tot["bound_ms"] += bound_ms
                tot["library_ms"] += l_ms
        del x, cot, cot_cl, y, want, want_grad, xd, mask
    torch.cuda.empty_cache()
    say(f"K3 over the four bf16 sites of one S||T forward: forward {totals['fwd']['ms']:.4f} ms, "
        f"backward {totals['bwd']['ms']:.4f} ms, byte bound {totals['fwd']['bound_ms']:.4f} ms, "
        f"F.dropout {totals['fwd']['library_ms']:.4f} ms, its backward "
        f"{totals['bwd']['library_ms']:.4f} ms")
    return totals


def small_batch(np, rng, b, size):
    return {
        "image_s": rng.standard_normal((b, size, size, 3)).astype(np.float32),
        "map_s": (rng.uniform(0, 1, (b, size, size, 2)) > 0.5).astype(np.float32),
        "boundary_s": rng.uniform(0, 1, (b, size, size, 1)).astype(np.float32),
        "image_t": rng.standard_normal((b, size, size, 3)).astype(np.float32),
    }


def small_parity_phase(torch, np, ports):
    """The port's train steps on the card (kernel path) and on the CPU
    (plain versions), same seed, dropout off, float32."""
    Config, create_train_state, make_train_step, layers = ports
    arrs = small_batch(np, np.random.default_rng(1), 2, 64)
    cfg = Config()
    cfg.method.mc_samples = 4
    # step 0: float32 noise of cuDNN vs CPU convolutions; step 1 inherits
    # Adam's first update, whose sign is noise where a gradient is ~0.
    # loss_aug counts pixels through two hard thresholds (pseudo-label and
    # MC-std confidence), which that noise may flip.
    runs = (("prototype_full", (False, True), {}),
            ("prototype_mt", (True, False), {"loss_aug": 5e-2}))
    for method, phases, loose in runs:
        losses = {}
        layers.set_dropout_impl("off")
        try:
            for device in ("cpu", "cuda"):
                state = create_train_state(cfg, seed=3, device=device, method=method)
                batch = {k: torch.from_numpy(v).to(device) for k, v in arrs.items()}
                out = []
                for proto in phases:
                    state, m = make_train_step(cfg, method, proto)(state, batch, 1e-5, 2.5e-5)
                    out.append({k: float(v) for k, v in m.items()})
                losses[device] = out
        finally:
            layers.set_dropout_impl("xla16")
        for i, rtol in enumerate((1e-3, 2e-2)):
            for k, want in losses["cpu"][i].items():
                got = losses["cuda"][i][k]
                tol = max(rtol, loose.get(k, 0.0))
                rel = abs(got - want) / max(abs(want), 1e-12)
                say(f"small {method} step {i} {k}: card {got:.6g} cpu {want:.6g} rel {rel:.2e} "
                    f"(tolerance {tol:g})")
                if not rel <= tol:
                    fail(f"small {method} step {i}: {k} disagrees between the card and the CPU")


def full_width_batch(torch, np):
    b, size = 8, 512
    arrs = small_batch(np, np.random.default_rng(0), b, size)
    return {k: torch.from_numpy(v).cuda() for k, v in arrs.items()}  # staged once


def full_width_cfg(Config):
    cfg = Config()
    cfg.model.compute_dtype = "bfloat16"
    cfg.method.mc_samples = 8
    return cfg


def reset_counts(mh, K3):
    mh.LAUNCHES = mh.LAUNCHES_BU = 0
    K3.LAUNCHES_FWD = K3.LAUNCHES_BWD = 0


def counts(mh, K3):
    return dict(k1=mh.LAUNCHES, k2=mh.LAUNCHES_BU, k3_fwd=K3.LAUNCHES_FWD, k3_bwd=K3.LAUNCHES_BWD)


def prototype_path(torch, np, ports, mh, K3, method: str, per_step: dict):
    """1 warmup + PROTO_STEPS prototype-phase steps of ``method`` at full
    width; the counts are set to 0 just before and checked after every step
    against ``per_step`` (launches per warmup / prototype-phase step).
    Returns the path's launch counts."""
    Config, create_train_state, make_train_step, _ = ports
    cfg = full_width_cfg(Config)
    batch = full_width_batch(torch, np)
    b = batch["image_s"].shape[0]
    state = create_train_state(cfg, seed=0, device="cuda", method=method)
    warm = make_train_step(cfg, method, proto_phase=False)
    proto = make_train_step(cfg, method, proto_phase=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts(mh, K3)  # counts from here on are this path's
    expect = {k: 0 for k in counts(mh, K3)}
    t0 = time.perf_counter()
    state, m = warm(state, batch, 1e-3, 2.5e-5)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    check_metrics(m, f"{method} warmup")
    for k, n in per_step["warmup"].items():
        expect[k] += n
    check_counts(mh, K3, expect, f"{method} warmup step")
    say(f"{method} warmup step: {warm_ms:.1f} ms (first step), {fmt(m)}")

    banks, step_ms = [], []
    for i in range(PROTO_STEPS):
        t0 = time.perf_counter()
        state, m = proto(state, batch, 1e-3, 2.5e-5)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check_metrics(m, f"{method} prototype step {i}")
        for k, n in per_step["proto"].items():
            expect[k] += n
        check_counts(mh, K3, expect, f"{method} prototype step {i}")
        banks.append(torch.cat([state.proto_src, state.proto_trg]).clone())
        say(f"{method} prototype step {i}: {step_ms[-1]:.1f} ms, {fmt(m)}")
    launches = counts(mh, K3)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    if not (bool(state.proto_src_init) and bool(state.proto_trg_init)):
        fail(f"{method}: the prototype banks were never seeded")
    for i, bank in enumerate(banks):
        if not bool(torch.isfinite(bank).all()) or float(bank.abs().max()) == 0.0:
            fail(f"{method}: prototype bank after step {i} is zero or not finite")
        if i and torch.equal(bank, banks[i - 1]):
            fail(f"{method}: prototype step {i} left the banks unchanged")
    # the first prototype-phase step includes the MC pass's first-call costs
    med = statistics.median(step_ms[1:])
    say(f"{method} prototype step: median {med:.2f} ms over steps 1-{PROTO_STEPS - 1}, "
        f"{b / (med / 1e3):.2f} img/s (source images per second), "
        f"peak memory {peak_gib:.2f} GiB, launches {launches}")
    del state, batch
    torch.cuda.empty_cache()
    return launches


def other_methods_phase(torch, np, ports, mh, K3):
    """Two full-width steps of each of the other single-forward methods
    under the default dropout backend; no hand-written kernel runs there."""
    Config, create_train_state, make_train_step, _ = ports
    cfg = full_width_cfg(Config)
    batch = full_width_batch(torch, np)
    keys = {
        "baseline": {"loss_seg", "loss_all"},
        "adversarial": {"loss_seg", "loss_adv", "loss_all", "loss_D", "loss_D2"},
        "posal": {"loss_seg", "loss_adv", "loss_all", "loss_D"},
        "mean_teacher": {"loss_seg", "loss_adv", "loss_all", "loss_D", "loss_D2",
                         "loss_consistency"},
    }
    for method, want_keys in keys.items():
        state = create_train_state(cfg, seed=0, device="cuda", method=method)
        step = make_train_step(cfg, method)
        reset_counts(mh, K3)
        for i in range(2):
            t0 = time.perf_counter()
            state, m = step(state, batch, 1e-3, 2.5e-5)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            check_metrics(m, f"{method} step {i}")
            if set(m) != want_keys:
                fail(f"{method}: metrics {sorted(m)}, want {sorted(want_keys)}")
            say(f"{method} step {i}: {ms:.1f} ms, {fmt(m)}")
        check_counts(mh, K3, {k: 0 for k in counts(mh, K3)}, method)
        del state, step
    torch.cuda.empty_cache()


def check_counts(mh, K3, expect: dict, where: str) -> None:
    got = counts(mh, K3)
    if got != expect:
        fail(f"{where}: kernel launches {got}, expected {expect}")


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
        import torch.nn.functional as F

        from uda_clr_tpu_torch.config import Config
        from uda_clr_tpu_torch.models import layers
        from uda_clr_tpu_torch.models.norm import batch_moments
        from uda_clr_tpu_torch.ops import cuda_build
        from uda_clr_tpu_torch.ops import dropout as K3
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
    libraries = (mh.LIBRARY, K3.LIBRARY)
    cuda_build.build_all(libraries)
    say(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{', '.join(lib.source.name for lib in libraries)} (nvcc for sm_90a, in parallel)")
    for lib in libraries:
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {lib.source.name}: {line.strip()}")

    mask_numbers = kernel_phase(torch, mh, batch_moments, kernel_seed)
    k3_numbers = dropout_phase(torch, F, K3)
    small_parity_phase(torch, np, ports)

    # the flagship path: K1 once per prototype-phase step, no K3 under 'xla16'
    flagship = prototype_path(torch, np, ports, mh, K3, "prototype_full", {
        "warmup": {}, "proto": {"k1": 1}})
    # the paper's full method under the fused dropout kernel
    sites = K3_SITES_PER_FORWARD
    layers.set_dropout_impl("pallas")
    try:
        mt = prototype_path(torch, np, ports, mh, K3, "prototype_mt", {
            "warmup": {"k3_fwd": sites, "k3_bwd": sites},
            "proto": {"k1": 1, "k3_fwd": 2 * sites, "k3_bwd": sites}})
    finally:
        layers.set_dropout_impl("xla16")
    other_methods_phase(torch, np, ports, mh, K3)

    def row(name, source, replaces, launches, nums, library_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": nums["max_abs_err"], "ms": nums["ms"],
                "plain_ms": nums["plain_ms"], "bound_ms": nums["bound_ms"], "bound_by": "bytes",
                "library_ms": library_ms}

    mask_src, drop_src = "uda_clr_tpu_torch/csrc/mask_head.cu", "uda_clr_tpu_torch/csrc/dropout.cu"
    kernels = [
        # no single PyTorch call computes the mask-head epilogue
        row("mask_head_split", mask_src, "uda_clr_tpu/ops/pallas/mask_head.py:154",
            flagship["k1"], mask_numbers["K1"], None),
        # K2 is on no train path (the JAX package calls fused_mask_head only in its tests)
        row("mask_head", mask_src, "uda_clr_tpu/ops/pallas/mask_head.py:65",
            mt["k2"], mask_numbers["K2"], None),
        # K3: times summed over the four dropout sites of one S||T forward
        row("dropout_forward", drop_src, "uda_clr_tpu/ops/pallas/dropout.py:70",
            mt["k3_fwd"], k3_numbers["fwd"], k3_numbers["fwd"]["library_ms"]),
        row("dropout_backward", drop_src, "uda_clr_tpu/ops/pallas/dropout.py:70",
            mt["k3_bwd"], k3_numbers["bwd"], k3_numbers["bwd"]["library_ms"]),
    ]
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
