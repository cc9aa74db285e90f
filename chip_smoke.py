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
   shape; K4, the norm, at the step's largest sites at 512^2, B 8+8 in
   bf16 channels_last ([16, 96, 258, 258], [16, 305, 128, 128] and
   [16, 256, 128, 128] split 8 | 8, the MC suffix's [64, 256, 128, 128] as
   one group): y, dx, the parameters' gradients and the running stats
   against the plain version in float32 on the same values, each pass
   (moments, normalize, reduce, dx) timed beside its byte bound, the bf16
   plain version's forward and backward, and ``F.batch_norm`` over each
   half (``library_ms`` only: the port never calls it); and TransNorm at
   [16, 256, 128, 128] split 8 | 8, with its four running buffers and K4's
   ``a1`` against ``transfer_factor``, checked only;
3. runs small train steps on the card and on the CPU from the same seed
   (float32, TF32 off, dropout off) and compares their metrics:
   ``prototype_full`` (warmup, then a prototype-phase step) under plain BN
   and under TransNorm, and ``prototype_mt`` (a prototype-phase step, then
   warmup);
3b. runs the train-throughput benchmark through its entry point
   (``uda_clr_tpu_torch.bench.main``: the flagship prototype-phase step at
   full width, 3 windows of 5 steps, then the u8/process and f32/thread
   host-fed rows of 4 steps), prints its JSON line and checks its keys,
   ``mfu`` in (0, 1], the card's name and power limit and one K1 launch per
   prototype-phase step; holds K1's flop formula to FlopCounterMode's count
   of its plain version at the main path's shape; and runs the serving
   benchmark (``uda_clr_tpu_torch.bench_eval.main``) at batches 8 and 32,
   printing its JSON line;
3c. runs the measurement tools through their entry points at full width,
   each printing its JSON line: the per-op roofline of the flagship step
   (``roofline_closure``, 2 profiled steps; its closure must hold: the ops'
   flops equal to ``count_flops``, their device ms within 1% of the
   trace's, no share above 1.05), bn against tn in one process
   (``bench_norm_ab``, 3 alternating windows of 3 steps each; tn/bn in
   [1.0, 1.6]), the batch scaling at B 8, 16 and 32 (2 windows of 3; the B
   8 row must run), the host-fed step against 1, 2 and all cores' thread
   workers (``bench_e2e``, 3 steps a row), the fast and slow MC passes over
   12 steps at 256^2 (``ab_mc_fast``; finite losses), the loader's img/s
   with the native library on and off (``bench_pipeline``) and thread
   against process workers (``bench_loader_backend``); one K1 launch per
   prototype-phase step of every tool that runs the flagship's fast MC
   pass, none elsewhere;
3d. trains the long-horizon family's flagship through its entry point
   (``uda_clr_tpu_torch.longrun.main``): at the family's size (64^2, B 2,
   T=4, float32, TF32 and dropout off) 60 iterations on the card, on the
   CPU and with the stem conv x (1 + 1e-6) on the card (iteration 0 card
   against CPU within 1e-4 per key; one K1 launch per iteration on the
   card); then at full width 100 iterations in bf16 under 'xla16' and 40
   in float32 with dropout off beside its chaos twin and a bf16 twin, all
   from one start (finite losses, a falling smoothed loss_all, one K1
   launch per iteration), printing each gap beside the chaos control's;
4. drives the flagship ``prototype_full`` step at full width (mobilenet
   DeepLabv3+ OS16, 512x512, 8 source + 8 target images, T=8 MC samples,
   bfloat16): one warmup step, then five prototype-phase steps, checking
   finite losses, moving prototype banks and one K1 launch per
   prototype-phase step. The step's prefix replays as CUDA graphs
   (train/graphs.py) from the warmup step on; a sixth prototype-phase step
   under ``torch.profiler`` must replay and run on the card the
   ``domain_norm`` kernels, name by name, of an eager prototype-phase step.
   That eager step and an eager warmup step run first on a second state of
   the same seed, whose norm modules carry forward hooks (a hook keeps the
   prefix eager): their K4 launches are checked against the generator's
   norm sites (one moments and one normalize a site, one reduce and one dx
   a site that takes a gradient, plus the MC suffix's 5 moments and 2
   normalizes);
5. drives ``prototype_mt`` at the same width under the fused dropout kernel
   (``set_dropout_impl('pallas')``): one warmup step, then five
   prototype-phase steps, asserting K1 and K3's launches per step;
6. drives, at the same width: the flagship under TransNorm (``norm='tn'``:
   the standalone fast MC forward, one K1 launch per prototype-phase step,
   1 warmup + 4 prototype-phase steps); the prototype-bank tool
   (``tools/cal_prototype.py``) on the card against the CPU at 64^2, then
   over 16 synthetic 512^2 target images, whose bank seeds the disk-bank
   paths; the disk-bank method ``prototype`` under TransNorm and the
   fused dropout kernel (1 warmup + 4 prototype-phase steps, K3 at the four
   sites forward and backward, no K1, a bank that moves every step); the
   flagship with the repeated-batch MC pass (``mc_fast=False``) under the
   fused dropout kernel (no K1; 4 + 16 forward and 4 backward K3 launches
   per prototype-phase step); and 2 prototype-phase steps of the bank
   method's woTN configuration (plain BN, no bu term, distance-weighted
   pseudo-labels from a frozen initial model); then prints each new path's
   median step beside the flagship's;
7. runs ``baseline``, ``adversarial``, ``posal`` and ``mean_teacher`` for
   two full-width steps each under the default dropout backend;
7b. holds each other backbone's DeepLab on the card to the CPU (an eval
   forward at 64^2, float32, TF32 off), then drives the flagship
   ``prototype_full`` at full width on ResNet-101 and Aligned Xception at
   output stride 16, DRN-D-54 (output stride 8) and mobilenet at output
   stride 8 (1 warmup + 3 prototype-phase steps, one K1 launch per
   prototype-phase step); ResNet-101 without and with rematerialised
   backbone blocks (peak memory, step time, and the gaps between their
   first-step losses and backbone running stats); and the ``bcdm`` method
   on mobilenet (1 + 2 steps) under the default dropout and under the fused
   dropout kernel (K3 4 x 14 forward and 4 x 12 backward launches per
   step), whose steps must move the second classifier and the backbone;
8. decodes each wire key's 256 uint8 values on the card and requires them
   bitwise equal to numpy's decode;
9. trains through the port's CLI in process (``uda_clr_tpu_torch.cli.main``):
   the flagship ``prototype_full`` at full width on synthetic data, uint8
   wire, 16 images (2 steps per epoch), warmup 0, validation every epoch,
   3 epochs, then ``--resume`` from that run's checkpoints to epoch 4;
   ``checkpoint_every`` is 1 (through ``--config``, the CLI's route for it)
   so the resume starts after the last epoch. It checks finite losses, the
   12-column ``log.csv`` with a row per step and per validation, the
   checkpoint, the resumed epoch and iteration, and one K1 launch per
   prototype-phase step (4, then 2), and prints each epoch's wall time,
   img/s, peak memory and the host time blocked on the loaders per step;
10. trains ``--method prototype --use_TN`` through the CLI's configuration
   at the same width with the bank of ``python -m
   uda_clr_tpu_torch.tools.cal_prototype --synthetic --use_TN`` (in
   process): 2 epochs with warmup 0, then ``--resume`` for a third, which
   must start at the checkpoint's next epoch and iteration with the saved
   bank and generator (TransNorm buffers included);
10b. trains ``--method bcdm --backbone drn`` through the CLI's
   configuration at the same width: 2 epochs, then ``--resume`` for a
   third, which must start at the checkpoint's next epoch and iteration
   with the saved second classifier and the three Adam states;
11. builds the native host augmentation (``csrc/fundus_aug.cpp``, g++,
   with the kernels) and holds it to the scipy path at 512^2 on ten seeds
   (+/-1, the share of differing pixels bounded; the boundary ring
   equal), the transforms' default path, with ms per sample of each;
12. trains the flagship through the CLI's configuration, 2 epochs, with
   each loader backend (threads, processes) and the native library on and
   off, printing the loader wait and wall per step beside the direct step;
13. trains it with ``viz_every`` 1 and ``save_val_images`` (64 validation
   images) and without: every tag file of the JAX Trainer's image grids
   and 8 validation strips per epoch, decoded to their shapes; the images'
   cost per epoch;
14. evaluates the checkpoint of step 12's first run with
   ``tools/evaluate.py --postprocess --save-viz`` on the card and on the
   CPU (metrics within EVAL_ATOL; ms per image); exports it with
   ``tools/export.py --selftest`` in f32 and u8 on the card, serves batch 2
   and 3 from one artifact, times a request of 8, and runs the payload with
   ``torch.export.load`` in an interpreter that refuses the port;
15. traces two flagship steps with ``utils/profiling.trace``;
16. data parallelism in two ranks on the one card (gloo; processes started
   with ``subprocess``, never forked after CUDA is up): the
   ``prototype_full`` prototype-phase step at full width in float32 (TF32
   and dropout off, 8 + 8 images, T=8) in one process and in two ranks of
   4 + 4, under ``bn`` and ``tn``, held to each other (the tight losses,
   running stats, parameters after the step, banks; the ranks bit for bit
   alike), and the float32 ``baseline`` step under ``tn`` (its source-only
   batch split by TransNorm over the global batch) held the same way; the
   flagship's bf16 step timed in two ranks beside the
   one-process step; ``prototype_mt`` under ``'pallas'`` for two steps in
   two ranks (K1 and K3 launches per rank, the ranks' K3 masks differ);
   then the CLI in two ranks, one ``python -m uda_clr_tpu_torch.cli
   --config`` per rank (full width, bf16, default dropout, a warmup epoch
   and a prototype-phase epoch): one K1 launch per prototype-phase step per
   rank, parameters equal bit for bit across ranks, one log.csv and one
   checkpoint set written by rank 0, and a two-rank resume for one more
   epoch. Two ranks sharing one card through gloo measure no scaling;
17. the ``('data', 'space')`` mesh on the one card, ranks sharing it through
   gloo (their halo rows staged through the host): on ``(1, 2)`` (2 ranks,
   each the top or bottom half of every image) and ``(2, 2)`` (4 ranks), the
   float32 prototype-phase step at full width under ``bn`` and ``tn`` held
   to step 16's one-process step as step 16 holds its ranks (the ranks bit
   for bit alike), the flagship's bf16 step timed per rank with each rank's
   peak device memory beside the one-process step's, one K1 launch per
   prototype-phase step per rank; on ``(1, 2)`` also ``prototype_mt`` under
   ``'pallas'`` (K1 and K3 per rank, the ranks' K3 masks differ) and the
   CLI with ``run.mesh_shape: [1, 2]`` (a warmup epoch and a
   prototype-phase epoch, one writer, parameters equal bit for bit);
18. prints a ``kernels`` JSON line (each kernel's launches summed over every
   path driven above, the data-parallel and spatial ranks' included: the
   host's calls of each wrapper, so K4's leave out what a replayed graph
   runs; beside them the card's ``domain_norm`` kernels of one replayed
   flagship step, as step 4's profiler counted them), the
   card's name and power limit, and as its last line ``{"ok": true,
   "device": {...}}``.

``python3 chip_smoke.py --dp-only`` builds the kernels and runs step 16
alone, ``--spatial-only`` step 17 alone (with its own one-process steps),
``--bench-only`` step 3b alone, ``--tools-only`` step 3c alone,
``--longrun-only`` step 3d alone, ``--norm-only`` K4's part of step 2
alone; none prints a result line.

It exits non-zero, with no result line, when there is no CUDA card, when
the port's package is not beside it, or when any phase fails. float32
comparisons run with TF32 off (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` both False) for the whole run.
"""

from __future__ import annotations

import contextlib
import csv
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

MAIN_SHAPE = (64, 128, 128)  # T*B rows of the MC pass at 512^2, B=8, T=8
# the dropout sites of one S||T forward at 512^2, B 8+8 (NCHW shape, rate):
# ASPP, boundary head 1 and 2, mask head
K3_SITES = (((16, 256, 32, 32), 0.5), ((16, 256, 128, 128), 0.5),
            ((16, 256, 128, 128), 0.1), ((16, 305, 128, 128), 0.1))
K3_F32_SITE = ((16, 256, 128, 128), 0.5)
# K4's sites (NCHW shape, images of the source group; None: one group)
K4_SITES = (((16, 96, 258, 258), 8), ((16, 305, 128, 128), 8), ((16, 256, 128, 128), 8),
            ((64, 256, 128, 128), None))
# Aligned Xception-65's eleven distinct site shapes at 512^2, B 8+8 (split 8 | 8)
K4_XCEPTION_SITES = tuple(((16, c, hw, hw), 8) for c, hw in (
    (32, 256), (64, 256), (128, 256), (128, 128), (256, 128), (256, 64), (728, 64),
    (728, 32), (1024, 32), (1536, 32), (2048, 32)))
# TransNorm's site (split 8 | 8), checked but not timed: its passes are
# BN's, plus the one small launch of a1
K4_TN_SITE = ((16, 256, 128, 128), 8)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# the launch counters a path reports: K1/K2 and K3, then K4's entries
K13_KEYS = ("k1", "k2", "k3_fwd", "k3_bwd")
K4_KEYS = ("k4_moments", "k4_fwd", "k4_reduce", "k4_dx")
# K4's moments and normalize launches in a prototype-phase step beyond the
# generator's norm sites: train/steps.py:mc_suffix's two batch_moments, one
# batch_moments_parts of three tensors and two normalizes
MC_SUFFIX_NORMS = (5, 2)
KERNEL_WINDOWS, KERNEL_PER_WINDOW = 5, 20
PLAIN_WINDOWS = 3
PROTO_STEPS = 5
# K3 launches of one train step under 'pallas': 4 model dropout sites per
# forward, one backward launch per site the loss reaches (all 4), and the
# augmented forward of prototype_mt (no backward with aug_backward off)
K3_SITES_PER_FORWARD = 4
# the backbones beside mobilenet OS16: (backbone, output stride); drn is
# always OS8. Each full-width path runs 1 warmup + BACKBONE_STEPS prototype
# steps
BACKBONE_CASES = (("resnet", 16), ("xception", 16), ("drn", 8), ("mobilenet", 8))
BACKBONE_STEPS = 3
# bcdm's head forwards per step (A 2, B 2 dead + 2, C 4 x 2) and those the
# backward reaches (all but B's dead two)
BCDM_HEAD_FORWARDS, BCDM_HEAD_BACKWARDS = 14, 12
# the Trainer phase: the CLI's flags for the flagship at full width
TRAINER_FLAGS = ["--synthetic", "--image-size", "512", "--batch-size", "8", "--bf16",
                 "--wire", "u8", "--warmup-epoch", "0", "--interval-validate", "1"]
WIRE_KEYS = ("image", "image_s", "image_t", "map", "map_s", "map_t",
             "boundary", "boundary_s", "boundary_t")
# data parallelism: ranks on the one card, and the metrics of the float32
# equivalence step by JAX's classification (tests/test_mesh_equivalence.py)
DP_WORLD = 2
DP_TIGHT = ("loss_seg", "loss_D", "loss_D2", "loss_adv")
DP_LOOSE = ("loss_intra", "loss_inter", "loss_all")
DP_LR = 1e-5  # lr_gen of the equivalence step: Adam's first step moves a parameter by <= lr
# tolerances of 2 ranks against 1 process at full width on the card, JAX's
# and the CPU tests' (tests/torch_dp_ranks.py), beside the gaps measured
# here (chip run 1, PR 8; bn / tn): tight 3.0e-7 / 3.6e-7, loose 9.0e-7 /
# 3.6e-7, running stats 5.4e-5 / 7.6e-5, parameters' median 0 lr, banks
# 8.9e-5 / 7.1e-5 (the target bank behind the pseudo-label thresholds; the
# CPU's 1e-4 left too little margin at full width). A per-rank-moments
# fault moves the tight losses by ~1e-2 (CPU, 64^2)
DP_TIGHT_ATOL = 1e-5  # absolute
DP_LOOSE_ATOL = 2e-2  # absolute
DP_STATS_RTOL = 3e-4  # of each running stat's largest entry (floor 1e-3)
DP_PARAM_MEDIAN_LR = 0.2  # median |diff| / lr of the generator's parameters
DP_BANK_ATOL = 5e-4
DP_RANK_TIMEOUT = 900  # seconds a rank process may take
# the ('data', 'space') meshes of the spatial phase, (n_data, n_space); the
# first also runs prototype_mt under 'pallas' and the CLI
SPATIAL_MESHES = ((1, 2), (2, 2))
# the bench phase: uda_clr_tpu_torch.bench with 3 windows of 5 steps and 4
# steps per host-fed row (the benchmark's own defaults are 5 x 10 and 12);
# its prototype-phase steps: the first call, 2 warm-up, the windows, the
# flop-counting step, and each host-fed row's untimed step and timed steps
BENCH_WINDOWS, BENCH_ITERS, BENCH_HOST_FED_STEPS = 3, 5, 4
BENCH_STEPS = 1 + 2 + BENCH_WINDOWS * BENCH_ITERS + 1 + 2 * (1 + BENCH_HOST_FED_STEPS)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "vs_baseline_range", "step_ms_median",
              "step_ms_windows", "mfu", "step_tflops", "host_fed", "host_fed_f32",
              "device_kind", "power_limit_w")
BENCH_EVAL_BATCHES = "8,32"
# the tools phase: the bounds on bench_norm_ab's tn/bn (PR 5 measured 1.132)
TN_OVER_BN = (1.0, 1.6)
# the long-horizon phase (uda_clr_tpu_torch.longrun): (a) the family's
# flagship size, card against CPU and the chaos twin; (b) full width, bf16
# with dropout on, float32 with dropout off and its chaos and bf16 twins
LONGRUN_SMALL_ITERS = 60
LONGRUN_ITER0_RTOL = 1e-4  # iteration 0, card against CPU, per key
LONGRUN_BF16_ITERS, LONGRUN_F32_ITERS = 100, 40


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


def norm_site(torch, K4, shape, k, mode: str, g) -> tuple:
    """One norm site in ``mode`` ('bn' or 'tn'), NCHW ``shape`` split at
    ``k`` (None: one group): K4's forward and backward in bf16
    channels_last against the plain version in float32 on the same values,
    for y, dx, the affine's gradients, every running buffer and, under
    TransNorm, K4's a1 against ``transfer_factor`` of the halves' plain
    moments. Fails outside the tolerances; returns (x, the cotangent, the
    two modules, the largest absolute error per output, the same over the
    largest reference entry)."""
    from uda_clr_tpu_torch.models.norm import DomainNorm2d, _moments, _unbias, transfer_factor

    n, c = shape[:2]
    x = (1.5 * torch.randn(shape, device="cuda", generator=g) + 0.4).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    cot = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    domains = 1 if k is None else 2
    mods = []
    for _ in range(2):
        m = DomainNorm2d(c, mode=mode).cuda()
        with torch.no_grad():
            m.weight.copy_(1 + 0.2 * torch.randn(c, device="cuda", generator=g))
            m.bias.copy_(0.2 * torch.randn(c, device="cuda", generator=g))
        mods.append(m)
    mods[1].load_state_dict(mods[0].state_dict())
    out = []
    for m, xi, ci, plain in ((mods[0], x, cot, False), (mods[1], x.float(), cot.float(), True)):
        xi = xi.clone().requires_grad_()
        y = (m.forward_plain if plain else m)(xi, True, domains)
        y.backward(ci)
        out.append({"y": y.detach().float(), "dx": xi.grad.float(), "dscale": m.weight.grad,
                    "dbias": m.bias.grad, **{name: b.clone() for name, b in m.named_buffers()}})
        del y, xi
    if mode == "tn":
        xf = x.float()
        (mu_s, v_s, n_s), (mu_t, v_t, n_t) = _moments([xf[:k], xf[k:]], (0, 2, 3))
        out[0]["a1"] = K4.tn_factor(K4.moments([(x, k)])[0], c, mods[0].eps)
        out[1]["a1"] = transfer_factor(mu_s, v_s * _unbias(n_s), mu_t, v_t * _unbias(n_t),
                                       mods[0].eps)
        del xf
    torch.cuda.synchronize()
    abs_err, rel_err = {}, {}
    for key, want in out[1].items():
        err = (out[0][key] - want).abs()
        top = float(want.abs().max())
        abs_err[key] = float(err.max())
        rel_err[key] = abs_err[key] / max(top, 1e-12)
        if key in ("y", "dx"):  # one bf16 rounding plus float32 noise
            ok = bool((err <= 2.0 ** -8 * want.abs() + 2e-5 * top).all())
        else:  # float32 sums of the same bf16 values in another order
            ok = rel_err[key] <= (1e-4 if key in ("dscale", "dbias") else 1e-5)
        if not ok:
            fail(f"K4 {mode} {key} at {list(shape)} split {k}: {abs_err[key]:.3e} "
                 f"({rel_err[key]:.3e} of the largest entry)")
    say(f"K4 {mode} {list(shape)} bf16 split {k}: within tolerance of the float32 plain "
        f"version (largest error over the largest entry: "
        f"{', '.join(f'{key} {e:.2e}' for key, e in rel_err.items())})")
    return x, cot, mods, abs_err, rel_err


def norm_phase(torch, F, K4):
    """K4 against its plain version in float32 at :data:`K4_SITES` and
    :data:`K4_XCEPTION_SITES` (BN) and :data:`K4_TN_SITE` (bf16,
    channels_last); at the BN sites each pass timed alone beside its byte
    bound. Returns each site's numbers and their sums."""
    g = torch.Generator("cuda").manual_seed(4)
    rows = []
    for shape, k in K4_SITES + K4_XCEPTION_SITES:
        x, cot, mods, abs_err, rel_err = norm_site(torch, K4, shape, k, "bn", g)
        c = shape[1]
        domains = 1 if k is None else 2
        # each pass alone: the moments, the normalize (EMA on), reduce, dx
        xd, w, b = x.detach(), mods[0].weight.detach(), mods[0].bias.detach()
        ema = [(mods[0].running_mean, mods[0].running_var)] * domains
        stats = K4.moments([(xd, k)])[0]
        with torch.no_grad():
            y = K4.normalize(xd, stats, k, w, b, 1e-5, ema)
        saved = torch.cat(K4.mean_var(stats, domains, c)[:2]).reshape(-1)
        saved[domains * c:] = torch.rsqrt(saved[domains * c:] + 1e-5)
        red = K4.reduce_launch(cot, xd, saved, k)
        times = {
            "moments": cuda_ms(lambda: K4.moments([(xd, k)]), KERNEL_WINDOWS, KERNEL_PER_WINDOW),
            "forward": cuda_ms(lambda: K4.normalize(xd, stats, k, w, b, 1e-5),
                               KERNEL_WINDOWS, KERNEL_PER_WINDOW),
            "reduce": cuda_ms(lambda: K4.reduce_launch(cot, xd, saved, k),
                              KERNEL_WINDOWS, KERNEL_PER_WINDOW),
            "dx": cuda_ms(lambda: K4.dx_launch(cot, xd, saved, w, k, red, stats),
                          KERNEL_WINDOWS, KERNEL_PER_WINDOW)}
        nbytes = xd.numel() * xd.element_size()
        bound = {key: f * nbytes / HBM_BYTES_PER_S * 1e3
                 for key, f in (("moments", 1), ("forward", 2), ("reduce", 2), ("dx", 3))}
        xg = xd.clone().requires_grad_()

        def plain():
            xg.grad = None
            mods[1].forward_plain(xg, True, domains).backward(cot)

        def library():
            halves = (xg,) if k is None else (xg[:k], xg[k:])
            xg.grad = None
            torch.cat([F.batch_norm(h, None, None, mods[1].weight, mods[1].bias, True)
                       for h in halves]).backward(cot)

        plain_ms = cuda_ms(plain, PLAIN_WINDOWS, 1)
        library_ms = cuda_ms(library, KERNEL_WINDOWS, 4)
        ms = sum(times.values())
        rows.append({"shape": list(shape), "k": k, "max_abs_err": abs_err,
                     "max_rel_err": rel_err, "ms": times, "bound_ms": bound,
                     "plain_ms": plain_ms, "library_ms": library_ms})
        say(f"K4 {list(shape)} bf16 split {k}: "
            + ", ".join(f"{key} {times[key]:.4f} ms ({100 * bound[key] / times[key]:.1f}% of "
                        f"{bound[key]:.4f})" for key in times)
            + f"; all {ms:.4f} ms against the bf16 plain version's {plain_ms:.3f} ms and "
            f"F.batch_norm per half {library_ms:.4f} ms (forward and backward)")
        del x, cot, xd, xg, y, stats, saved, red, mods
        torch.cuda.empty_cache()
    shape, k = K4_TN_SITE
    _, _, _, tn_abs, tn_rel = norm_site(torch, K4, shape, k, "tn", g)
    torch.cuda.empty_cache()
    errs = [(r["max_abs_err"], r["max_rel_err"]) for r in rows] + [(tn_abs, tn_rel)]
    flagship = rows[:len(K4_SITES)]  # the sums stay K4_SITES' alone
    totals = {"ms": sum(sum(r["ms"].values()) for r in flagship),
              "bound_ms": sum(sum(r["bound_ms"].values()) for r in flagship),
              "plain_ms": sum(r["plain_ms"] for r in flagship),
              "library_ms": sum(r["library_ms"] for r in flagship),
              "max_abs_err": max(max(a.values()) for a, _ in errs),
              "max_rel_err": max(max(r.values()) for _, r in errs)}
    say(json.dumps({"k4_sites": rows, "k4_tn_site": {"shape": list(shape), "k": k,
                                                     "max_abs_err": tn_abs,
                                                     "max_rel_err": tn_rel},
                    "k4_totals": totals}))
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
    # step 0: float32 noise of cuDNN vs CPU convolutions; step 1 inherits
    # Adam's first update, whose sign is noise where a gradient is ~0.
    # loss_aug counts pixels through two hard thresholds (pseudo-label and
    # MC-std confidence), which that noise may flip. The TransNorm step runs
    # the standalone fast MC forward (K1 with doubled coefficients) first:
    # after an Adam step its loss_intra moved 4% on the CPU alone for a 1e-6
    # relative change of the inputs (pixels cross the 0.75 pseudo-label
    # threshold), before one by 7e-5.
    runs = (("prototype_full", (False, True), {}, "bn"),
            ("prototype_mt", (True, False), {"loss_aug": 5e-2}, "bn"),
            ("prototype_full", (True, False), {}, "tn"))
    for method, phases, loose, norm in runs:
        cfg = Config()
        cfg.method.mc_samples = 4
        cfg.model.norm = norm
        losses = {}
        layers.set_dropout_impl("off")
        try:
            for device in ("cpu", "cuda"):
                state = create_train_state(cfg, seed=3, device=device, method=method)
                batch = {k: torch.from_numpy(v).to(device) for k, v in arrs.items()}
                out = []
                for proto in phases:
                    state, m = make_train_step(cfg, method, proto)(state, batch, 1e-5, 2.5e-5)
                    take_viz(m, f"small {method} ({norm})", device)
                    out.append({k: float(v) for k, v in m.items()})
                losses[device] = out
        finally:
            layers.set_dropout_impl("xla16")
        for i, rtol in enumerate((1e-3, 2e-2)):
            for k, want in losses["cpu"][i].items():
                got = losses["cuda"][i][k]
                tol = max(rtol, loose.get(k, 0.0))
                rel = abs(got - want) / max(abs(want), 1e-12)
                say(f"small {method} ({norm}) step {i} {k}: card {got:.6g} cpu {want:.6g} "
                    f"rel {rel:.2e} (tolerance {tol:g})")
                if not rel <= tol:
                    fail(f"small {method} ({norm}) step {i}: {k} disagrees between the card "
                         f"and the CPU")


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
    from uda_clr_tpu_torch.ops import domain_norm as K4

    mh.LAUNCHES = mh.LAUNCHES_BU = 0
    K3.LAUNCHES_FWD = K3.LAUNCHES_BWD = 0
    K4.LAUNCHES_MOMENTS = K4.LAUNCHES_FWD = K4.LAUNCHES_REDUCE = K4.LAUNCHES_BWD = 0


def counts(mh, K3):
    """Every kernel's launches since :func:`reset_counts`: K1/K2, K3 and
    K4's four entries (:data:`K4_KEYS`)."""
    from uda_clr_tpu_torch.ops import domain_norm as K4

    return dict(k1=mh.LAUNCHES, k2=mh.LAUNCHES_BU, k3_fwd=K3.LAUNCHES_FWD, k3_bwd=K3.LAUNCHES_BWD,
                k4_moments=K4.LAUNCHES_MOMENTS, k4_fwd=K4.LAUNCHES_FWD,
                k4_reduce=K4.LAUNCHES_REDUCE, k4_dx=K4.LAUNCHES_BWD)


def same_counts(got: dict, want: dict) -> bool:
    """Whether ``got`` holds ``want``'s counts (the keys ``want`` names)."""
    return {k: got.get(k, 0) for k in want} == want


def card_kernels(torch, prof, word: str = "domain_norm") -> dict:
    """The card's kernels whose names hold ``word`` in a ``torch.profiler``
    run, counted by name."""
    got: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and word in e.name():
            got[e.name()] = got.get(e.name(), 0) + 1
    return got


def norm_sites(torch, mh, K3, ports, cfg, method: str, batch, proto_bank, norm_suffix) -> dict:
    """An eager warmup step and an eager prototype-phase step of ``method``
    on a state of seed 0, its norm modules hooked (a module hook keeps the
    step's prefix eager, train/graphs.py): K4's launches in each held to
    the generator's norm sites (one moments launch per train-mode site, plus
    ``norm_suffix``'s moments and normalize launches in the prototype-phase
    step outside the norm modules; one normalize per site; one reduce and
    one dx per site whose output takes a gradient). Returns the card's
    ``domain_norm`` kernels of the prototype-phase step under
    ``torch.profiler``, by name."""
    from torch.profiler import ProfilerActivity, profile

    from uda_clr_tpu_torch.models.norm import DomainNorm2d

    _, create_train_state, make_train_step, _ = ports
    state = create_train_state(cfg, seed=0, device="cuda", method=method, proto_bank=proto_bank)
    sites = {"all": 0, "train": 0, "grad": 0}

    def count_site(module, inputs, output):
        sites["all"] += 1
        sites["train"] += int(bool(inputs[1]))
        sites["grad"] += int(output.requires_grad)

    for m in state.gen.modules():
        if isinstance(m, DomainNorm2d):
            m.register_forward_hook(count_site)
    card = None
    for proto, extra in ((False, (0, 0)), (True, norm_suffix)):
        step = make_train_step(cfg, method, proto_phase=proto)
        reset_counts(mh, K3)
        with profile(activities=[ProfilerActivity.CUDA]) if proto else contextlib.nullcontext() \
                as prof:
            state, _ = step(state, batch, 1e-3, 2.5e-5)
            torch.cuda.synchronize()
        want = dict(zip(K4_KEYS, (sites["train"] + extra[0], sites["all"] + extra[1],
                                  sites["grad"], sites["grad"])))
        got = {k: v for k, v in counts(mh, K3).items() if k in K4_KEYS}
        if got != want:
            fail(f"{method} eager {'prototype' if proto else 'warmup'} step: K4 launches {got}, "
                 f"its norm sites give {want}")
        sites.update(all=0, train=0, grad=0)
        if proto:
            card = card_kernels(torch, prof)
    say(f"{method} eager steps: K4 launches per norm site as expected; the eager "
        f"prototype-phase step ran {sum(card.values())} domain_norm kernels on the card")
    del state
    torch.cuda.empty_cache()
    return card


def prototype_path(torch, np, ports, mh, K3, method: str, per_step: dict, name: str = "",
                   steps: int = PROTO_STEPS, warmup: bool = True, configure=None,
                   proto_bank=None, keys=None, banks_move: bool = True, info=None,
                   norm_suffix=None):
    """1 warmup (unless ``warmup`` is False) + ``steps`` prototype-phase
    steps of ``method`` at full width (``configure(cfg)`` edits the
    configuration; ``proto_bank`` seeds the disk bank of ``prototype``);
    the counts are set to 0 just before and checked after every step
    against ``per_step`` (launches per warmup / prototype-phase step), the
    metrics' names against ``keys`` when given, and the banks must move
    every step (unless ``banks_move`` is False: then it is only said).
    With ``norm_suffix`` (the K4 moments and normalize launches a
    prototype-phase step makes outside the generator's norm modules) K4 is
    checked too: :func:`norm_sites` first, on eager steps; then, after the
    timed steps, one more prototype-phase step under ``torch.profiler``,
    whose prefix must replay and whose card must run the eager step's
    ``domain_norm`` kernels (``info["k4_card"]``). Returns the path's
    launch counts (the host's calls) and the median step ms (over steps 1
    on: step 0 carries first-call costs); fills ``info`` (a dict) with the
    peak GiB, img/s, the warmup step's ms and metrics and the generator's
    backbone running stats after it."""
    from uda_clr_tpu_torch.utils import tracing

    Config, create_train_state, make_train_step, _ = ports
    name = name or method
    cfg = full_width_cfg(Config)
    if configure is not None:
        configure(cfg)
    batch = full_width_batch(torch, np)
    b = batch["image_s"].shape[0]
    k4_card = norm_sites(torch, mh, K3, ports, cfg, method, batch, proto_bank,
                         norm_suffix) if norm_suffix else None
    state = create_train_state(cfg, seed=0, device="cuda", method=method, proto_bank=proto_bank)
    warm = make_train_step(cfg, method, proto_phase=False)
    proto = make_train_step(cfg, method, proto_phase=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tracing.clear_counts()

    reset_counts(mh, K3)  # counts from here on are this path's
    expect = dict.fromkeys(K13_KEYS, 0)
    if warmup:
        t0 = time.perf_counter()
        state, m = warm(state, batch, 1e-3, 2.5e-5)
        torch.cuda.synchronize()
        take_viz(m, f"{name} warmup")
        warm_ms = (time.perf_counter() - t0) * 1e3
        check_metrics(m, f"{name} warmup")
        for k, n in per_step["warmup"].items():
            expect[k] += n
        check_counts(mh, K3, expect, f"{name} warmup step")
        say(f"{name} warmup step: {warm_ms:.1f} ms (first step), {fmt(m)}")
        if info is not None:
            info.update(warm_ms=warm_ms, warm_metrics={k: float(v) for k, v in m.items()},
                        backbone_stats={k: v.clone() for k, v in
                                        state.gen.backbone.named_buffers()})

    banks, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = proto(state, batch, 1e-3, 2.5e-5)
        torch.cuda.synchronize()
        tiles = take_viz(m, f"{name} prototype step {i}")
        if method in ("prototype_full", "prototype_mt") and not {"std_t", "conf_t"} <= set(tiles):
            fail(f"{name}: the rectified prototype step returned no std/confidence tiles")
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check_metrics(m, f"{name} prototype step {i}")
        if keys is not None and set(m) != keys:
            fail(f"{name}: metrics {sorted(m)}, want {sorted(keys)}")
        for k, n in per_step["proto"].items():
            expect[k] += n
        check_counts(mh, K3, expect, f"{name} prototype step {i}")
        if method == "prototype":
            banks.append(torch.cat([state.proto_bank[k] for k in ("cup", "disc")]).clone())
        else:
            banks.append(torch.cat([state.proto_src, state.proto_trg]).clone())
        say(f"{name} prototype step {i}: {step_ms[-1]:.1f} ms, {fmt(m)}")
    if norm_suffix:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, m = proto(state, batch, 1e-3, 2.5e-5)
            torch.cuda.synchronize()
        take_viz(m, f"{name} profiled prototype step")
        check_metrics(m, f"{name} profiled prototype step")
        for k, n in per_step["proto"].items():
            expect[k] += n
        check_counts(mh, K3, expect, f"{name} profiled prototype step")
        graphed, card = tracing.graph_counts(), card_kernels(torch, prof)
        if graphed["capture"] != 1 or graphed["eager"] or graphed["replay"] != steps + warmup:
            fail(f"{name}: the step's prefix ran {graphed}, want one capture, then replays")
        if card != k4_card:
            fail(f"{name}: a replayed prototype-phase step ran the domain_norm kernels {card}, "
                 f"an eager one {k4_card}")
        say(f"{name} profiled prototype step: the prefix replayed ({graphed}); "
            f"{sum(card.values())} domain_norm kernels on the card, as eagerly")
        if info is not None:
            info.update(k4_card=card)
    launches = counts(mh, K3)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    if method != "prototype" and not (bool(state.proto_src_init) and bool(state.proto_trg_init)):
        fail(f"{name}: the prototype banks were never seeded")
    for i, bank in enumerate(banks):
        if not bool(torch.isfinite(bank).all()) or float(bank.abs().max()) == 0.0:
            fail(f"{name}: prototype bank after step {i} is zero or not finite")
        if i and torch.equal(bank, banks[i - 1]):
            if banks_move:
                fail(f"{name}: prototype step {i} left the banks unchanged")
            say(f"{name}: prototype step {i} left the banks unchanged (no target pixel "
                f"passed the thresholds)")
    med = statistics.median(step_ms[1:])
    say(f"{name} prototype step: median {med:.2f} ms over steps 1-{steps - 1}, "
        f"{b / (med / 1e3):.2f} img/s (source images per second), "
        f"peak memory {peak_gib:.2f} GiB, launches {launches}")
    if info is not None:
        info.update(peak_gib=peak_gib, img_per_s=b / (med / 1e3), ms=med)
    del state, batch
    torch.cuda.empty_cache()
    return launches, med


def backbone_card_phase(torch, np, DeepLab):
    """Each backbone's DeepLab on the card against the same weights on the
    CPU: an eval-mode forward at 64^2, B=2, float32 (TF32 off for matmul
    and cuDNN), with random norm affine and running stats; every output
    within 1e-4 of its largest CPU entry (cuDNN and the CPU sum the
    convolutions in other orders; the CPU and JAX agree to <= 1e-5 there,
    tests/test_torch_backbone_*.py)."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 64, 64, 3))
                         .astype(np.float32))
    for backbone, output_stride in BACKBONE_CASES:
        gen = DeepLab(backbone=backbone, output_stride=output_stride, seed=0)
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for name, t in gen.named_parameters():
                if t.dim() == 1 and name.endswith("weight"):  # norm scales
                    t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=g))
            for name, t in gen.named_buffers():
                t.copy_(0.1 * torch.randn(t.shape, generator=g) if "mean" in name
                        else 0.5 + torch.rand(t.shape, generator=g))
            want = gen(x, False)
            gen.cuda().to(memory_format=torch.channels_last)
            got = gen(x.cuda(), False)
        torch.cuda.synchronize()
        errs = {n: float((a.cpu() - b).abs().max() / b.abs().max())
                for n, a, b in zip(got._fields, got, want)}
        worst = max(errs, key=errs.get)
        say(f"{backbone} OS{gen.output_stride} eval forward at 64^2, card vs cpu (float32, TF32 "
            f"off): largest difference {errs[worst]:.2e} of the largest entry, at {worst} "
            f"(tolerance 1e-4)")
        if not errs[worst] <= 1e-4:
            fail(f"{backbone}: the eval forward disagrees between the card and the CPU")
        del gen, want, got
    torch.cuda.empty_cache()


def remat_phase(torch, np, ports, mh, K3) -> dict:
    """``prototype_full`` on resnet, OS16, without and with rematerialised
    backbone blocks, from the same seed and batch: peak memory and step
    time of both, the gap between their warmup losses and between their
    backbone running stats after that one step (a second EMA in the
    backward's recompute would move them by ~10%). Returns the launch
    counts of both runs."""
    runs = {}
    for remat in (False, True):
        info = {}

        def configure(c, remat=remat):
            c.model.backbone = "resnet"
            c.model.remat = remat

        launches, _ = prototype_path(torch, np, ports, mh, K3, "prototype_full", {
            "warmup": {}, "proto": {"k1": 1}}, name=f"prototype_full resnet remat={remat}",
            steps=BACKBONE_STEPS, configure=configure, info=info)
        runs[remat] = (launches, info)
    (l0, a), (l1, b) = runs[False], runs[True]
    loss_gap = max(abs(a["warm_metrics"][k] - b["warm_metrics"][k])
                   / max(abs(a["warm_metrics"][k]), 1e-12) for k in a["warm_metrics"])
    stats_gap = max(float((a["backbone_stats"][k] - v).abs().max()
                          / v.abs().max().clamp_min(1e-12))
                    for k, v in b["backbone_stats"].items())
    say(f"remat on resnet prototype_full: peak {a['peak_gib']:.2f} -> {b['peak_gib']:.2f} GiB "
        f"({b['peak_gib'] / a['peak_gib']:.3f}x), step {a['ms']:.2f} -> {b['ms']:.2f} ms "
        f"({b['ms'] / a['ms']:.3f}x); warmup-step losses apart by {loss_gap:.2e} (relative), "
        f"backbone running stats after it by {stats_gap:.2e} of the largest entry "
        f"(tolerance 1e-3 each)")
    if not (loss_gap <= 1e-3 and stats_gap <= 1e-3):
        fail("remat: the first step's losses or backbone running stats differ from "
             "the plain model's")
    return {k: l0[k] + l1[k] for k in l0}


def bcdm_phase(torch, np, ports, mh, K3, impl: str) -> tuple[dict, float]:
    """``bcdm`` on mobilenet at full width under the dropout backend
    ``impl``: 1 + 2 steps, each with its K3 launches asserted (under
    'pallas' 4 sites x 14 head forwards and 4 x 12 backward: phase A's two
    heads, B's two dead and two live ones, C's 4 x 2; none under 'xla16')
    and finite losses; the steps must move the second classifier and the
    backbone. Returns the launch counts and the median step ms of steps
    1-2."""
    Config, create_train_state, make_train_step, layers = ports
    cfg = full_width_cfg(Config)
    batch = full_width_batch(torch, np)
    per_step = {"k1": 0, "k2": 0, "k3_fwd": 0, "k3_bwd": 0}
    if impl == "pallas":
        per_step.update(k3_fwd=K3_SITES_PER_FORWARD * BCDM_HEAD_FORWARDS,
                        k3_bwd=K3_SITES_PER_FORWARD * BCDM_HEAD_BACKWARDS)
    layers.set_dropout_impl(impl)
    try:
        state = create_train_state(cfg, seed=0, device="cuda", method="bcdm")
        step = make_train_step(cfg, "bcdm")
        cls2 = {k: v.clone() for k, v in state.cls2.state_dict().items()}
        stem = state.gen.backbone.features[0][0].weight.detach().clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(mh, K3)
        step_ms = []
        for i in range(3):
            t0 = time.perf_counter()
            state, m = step(state, batch, 1e-3, 2.5e-5)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            take_viz(m, f"bcdm {impl} step {i}")
            check_metrics(m, f"bcdm {impl} step {i}")
            if set(m) != {"loss_seg", "loss_cdd_before", "loss_cdd_after", "loss_all"}:
                fail(f"bcdm: metrics {sorted(m)}")
            check_counts(mh, K3, {k: (i + 1) * n for k, n in per_step.items()},
                         f"bcdm {impl} step {i}")
            say(f"bcdm {impl} step {i}: {step_ms[-1]:.1f} ms, {fmt(m)}")
        launches = counts(mh, K3)
    finally:
        layers.set_dropout_impl("xla16")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if all(torch.equal(v, state.cls2.state_dict()[k]) for k, v in cls2.items()) or \
            torch.equal(stem, state.gen.backbone.features[0][0].weight):
        fail(f"bcdm {impl}: the steps left the second classifier or the backbone unchanged")
    steps = {name: {int(s["step"]) for s in opt.state.values()}
             for name, opt in state.bcdm_opt.items()}
    if steps != {"fea": {15}, "cls1": {6}, "cls2": {6}}:
        fail(f"bcdm {impl}: Adam step counts {steps}, expected fea 15, cls1 6, cls2 6")
    med = statistics.median(step_ms[1:])
    say(f"bcdm {impl} step: median {med:.2f} ms over steps 1-2, {8 / (med / 1e3):.2f} img/s "
        f"(source images per second), peak memory {peak:.2f} GiB, launches {launches}; "
        f"Adam steps fea 15, cls1 6, cls2 6; cls2 and the backbone moved")
    del state, batch
    torch.cuda.empty_cache()
    return launches, med


def bcdm_trainer_phase(torch, trainer_ports, mh, K3) -> dict:
    """``--method bcdm --backbone drn`` through the port's CLI at full
    width: 2 epochs, then ``--resume`` for a third, which must start at the
    checkpoint's next epoch and iteration with the saved second classifier
    and Adam states (step counts fea 5, cls1 2, cls2 2 per iteration).
    Returns the launch counts (none: no kernel is on this path under the
    default dropout)."""
    cli, _, headers, _ = trainer_ports
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bcdm_")
    total = {k: 0 for k in counts(mh, K3)}
    try:
        cfg = cli.build_config(TRAINER_FLAGS + ["--max-epoch", "2", "--method", "bcdm",
                                                "--backbone", "drn"])
        cfg.run.checkpoint_every = 1
        cls2 = lambda state: state.cls2.state_dict()

        def adam_steps(trainer):
            return {name: {int(s["step"]) for s in opt.state.values()}
                    for name, opt in trainer.state.bcdm_opt.items()}

        first, _, _ = cli_run(torch, trainer_ports, mh, K3, cfg, tmp, "bcdm trainer", "first",
                              cls2, total)
        # bcdm logs loss_seg alone of the CSV's train columns
        check_run(first, os.path.join(tmp, "first"), headers, 0, [0, 1], "bcdm trainer first",
                  columns=(2,))
        if first.state.gen.output_stride != 8 or adam_steps(first) != {
                "fea": {20}, "cls1": {8}, "cls2": {8}}:
            fail(f"bcdm trainer first: OS {first.state.gen.output_stride}, Adam steps "
                 f"{adam_steps(first)}")
        cfg.run.max_epoch = 3
        second, loaded, start = cli_run(torch, trainer_ports, mh, K3, cfg, tmp, "bcdm trainer",
                                        "resumed", cls2, total, "--resume",
                                        os.path.join(tmp, "first", "checkpoints"))
        if start != (2, first.iteration) or [s["epoch"] for s in second.epoch_stats] != [2]:
            fail(f"bcdm trainer resumed: started at (epoch, iteration) {start}, expected "
                 f"(2, {first.iteration})")
        for k, v in first.state.cls2.state_dict().items():
            if not torch.equal(loaded[k], v):
                fail(f"bcdm trainer resumed: the loaded second classifier's {k} differs")
        if adam_steps(second) != {"fea": {30}, "cls1": {12}, "cls2": {12}}:
            fail(f"bcdm trainer resumed: Adam steps {adam_steps(second)}")
        say(f"bcdm trainer resumed: started at epoch 2, iteration {first.iteration + 1}, with the "
            f"saved second classifier and Adam states (fea 20, cls1 8, cls2 8 -> 30, 12, 12)")
        del first, second
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return total


def bank_tool_phase(torch, np, bank_ports):
    """The prototype-bank tool's ``compute_prototypes`` with a TransNorm
    generator (seed 0) on the card: at 64^2 on 2 synthetic images against
    the same weights on the CPU, then over 16 synthetic 512^2 target images
    (the bank the full-width disk-bank paths start from). Before each, the
    generator's running stats are set from one train-mode S||T forward at
    that size (momentum 1), as a trained generator's would be: at their
    init values every TransNorm layer of the eval forward doubles its
    output, and the thresholded pools flip with the float noise."""
    compute_prototypes, DeepLab, DomainNorm2d, SyntheticFundus, eval_transforms, BatchLoader = \
        bank_ports
    gen = DeepLab(norm="tn", seed=0)

    def batches(n, size, seed=2):
        ds = SyntheticFundus(n, size + 28, seed=seed, transform=eval_transforms(size))
        return BatchLoader(ds, 8, shuffle=False, drop_last=False, num_workers=2).epoch(0)

    norms = [m for m in gen.modules() if isinstance(m, DomainNorm2d)]

    def set_running_stats(size):
        """The running stats from one train-mode S||T forward of 2 + 2
        images at ``size`` (momentum 1), on the generator's device."""
        device = next(gen.parameters()).device
        x = np.concatenate([next(iter(batches(2, size, seed=seed)))["image"] for seed in (1, 2)])
        for m in norms:
            m.momentum = 1.0
        with torch.no_grad():
            gen(torch.from_numpy(x).to(device), train=True, domains=2)
        for m in norms:
            m.momentum = 0.1

    small = list(batches(2, 64))
    set_running_stats(64)
    want = compute_prototypes(gen, small)
    # the pools' own sensitivity: a 1e-6 relative change of the input
    nudged = compute_prototypes(gen, [{"image": b["image"] * np.float32(1 + 1e-6)}
                                      for b in small])
    gen.cuda().to(memory_format=torch.channels_last)
    got = compute_prototypes(gen, small)
    for k, v in want.items():
        scale = max(float(np.abs(v).max()), 1e-12)
        err = float(np.abs(got[k] - v).max()) / scale
        sens = float(np.abs(nudged[k] - v).max()) / scale
        tol = max(1e-4, 10 * sens)
        say(f"bank tool, 2 images at 64^2, {k}[{v.shape[0]}]: card vs cpu {err:.2e} of the "
            f"largest entry; a 1e-6 relative input change moves it {sens:.2e} on the CPU "
            f"(tolerance {tol:.2e}, ten times that)")
        if not err <= tol:
            fail(f"bank tool: {k} disagrees between the card and the CPU")
    # at 512^2 with the stats of 64^2 the eval logits are ~1e2 and nearly
    # constant over an image, so whether any cup pixel passes its threshold
    # flips with the float noise (on an H100 no cup pixel passed at all)
    set_running_stats(512)
    t0 = time.perf_counter()
    bank = compute_prototypes(gen, batches(16, 512))
    seconds = time.perf_counter() - t0
    sizes = {"bu": 304, "cup": 305, "disc": 305}
    for k, n in sizes.items():
        v = bank[k]
        if v.shape != (n,) or not np.all(np.isfinite(v)) or float(np.abs(v).max()) == 0.0:
            fail(f"bank tool: {k} {v.shape} is zero, not finite or misshapen")
    say(f"bank tool: 16 synthetic 512^2 images in {seconds:.2f} s (host transforms included); "
        + ", ".join(f"{k} |max| {float(np.abs(v).max()):.4g}" for k, v in bank.items()))
    del gen
    torch.cuda.empty_cache()
    return bank


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
            take_viz(m, f"{method} step {i}")
            check_metrics(m, f"{method} step {i}")
            if set(m) != want_keys:
                fail(f"{method}: metrics {sorted(m)}, want {sorted(want_keys)}")
            say(f"{method} step {i}: {ms:.1f} ms, {fmt(m)}")
        check_counts(mh, K3, dict.fromkeys(K13_KEYS, 0), method)
        del state, step
    torch.cuda.empty_cache()


def wire_phase(torch, np, wire):
    """Each wire key's 256 uint8 values decoded on the card, bitwise against
    numpy's decode (a divide by a float32 tensor on the card, not a
    multiply by the reciprocal)."""
    u = np.arange(256, dtype=np.uint8)
    for key in WIRE_KEYS:
        got = wire.decode_batch({key: torch.from_numpy(u).cuda()})[key]
        want = wire.decode_array(key, u)
        if got.dtype != torch.float32 or not np.array_equal(
                got.cpu().numpy().view(np.uint32), want.view(np.uint32)):
            fail(f"wire decode of {key!r} on the card differs from numpy's")
    say(f"wire: the decode of all 256 uint8 values equals numpy's bitwise on the card "
        f"for {len(WIRE_KEYS)} keys")


def check_run(trainer, out: str, headers, first_iteration: int, epochs: list, where: str,
              columns=(2, 5, 6, 7)):
    """log.csv of a CLI run: the 12-column header, one row per step
    (consecutive iterations from ``first_iteration``) finite in
    ``columns`` (loss_seg, loss_adv, loss_D, loss_D2 by default), and one
    finite row per validation."""
    with open(os.path.join(out, "log.csv")) as f:
        rows = list(csv.reader(f))
    if rows[0] != headers or len(headers) != 12:
        fail(f"{where}: log.csv header {rows[0]}")
    train = [r for r in rows[1:] if r[2]]
    valid = [r for r in rows[1:] if not r[2]]
    steps = sum(s["steps"] for s in trainer.epoch_stats)
    if [int(r[1]) for r in train] != list(range(first_iteration, first_iteration + steps)):
        fail(f"{where}: train rows at iterations {[r[1] for r in train]}")
    if [int(r[0]) for r in valid] != epochs or [s["epoch"] for s in trainer.epoch_stats] != epochs:
        fail(f"{where}: validation rows for epochs {[r[0] for r in valid]}, want {epochs}")
    for r in train:
        if len(r) != 12 or not all(math.isfinite(float(r[i])) for i in columns):
            fail(f"{where}: train row {r} is not finite")
    for r in valid:
        if len(r) != 13 or not all(math.isfinite(float(r[i])) for i in (8, 9, 10)):
            fail(f"{where}: validation row {r} is not finite")


def trainer_phase(torch, trainer_ports, mh, K3, direct_ms: float) -> dict:
    """The flagship through the port's CLI: 3 epochs, then a resume to 4.
    Returns the launch counts of both runs."""
    cli, ckpt_lib, headers, _ = trainer_ports
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        def run(name, max_epoch, *extra):
            cfg = cli.build_config(TRAINER_FLAGS + ["--max-epoch", str(max_epoch)])
            cfg.run.checkpoint_every = 1  # every validation writes a checkpoint
            path = os.path.join(tmp, name + ".yaml")
            with open(path, "w") as f:
                f.write(cfg.to_yaml())
            out = os.path.join(tmp, name)
            reset_counts(mh, K3)
            t0 = time.perf_counter()
            trainer = cli.main(["--config", path, "--out", out, *extra])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = counts(mh, K3)
            proto_steps = sum(s["steps"] for s in trainer.epoch_stats if s["proto_phase"])
            for s in trainer.epoch_stats:
                phase = "prototype phase" if s["proto_phase"] else "warmup"
                rest = (s["seconds"] - s["loader_wait_s"]) / s["steps"]
                say(f"trainer {name} epoch {s['epoch']} ({phase}): wall {s['seconds']:.3f} s for "
                    f"{s['steps']} steps, {s['img_per_s']:.2f} img/s, peak memory "
                    f"{s['peak_gib']:.2f} GiB, loader wait {1e3 * s['loader_wait_s'] / s['steps']:.1f} "
                    f"ms/step, the rest {1e3 * rest:.1f} ms/step")
            say(f"trainer {name}: {seconds:.1f} s in cli.main (datasets, model, training, "
                f"validation, checkpoints); launches {launches}")
            want = dict.fromkeys(K13_KEYS, 0)
            want["k1"] = proto_steps
            if not same_counts(launches, want):
                fail(f"trainer {name}: kernel launches {launches}, expected {want} "
                     f"(one K1 launch per prototype-phase step)")
            return trainer, out, launches

        first, out1, c1 = run("first", 3)
        check_run(first, out1, headers, 0, [0, 1, 2], "trainer first")
        if c1["k1"] != 4:
            fail(f"trainer first: {c1['k1']} K1 launches, expected 4")
        ckpt_dir = os.path.join(out1, "checkpoints")
        tag = ckpt_lib.latest_checkpoint(ckpt_dir)
        if tag != "checkpoint_3" or first.iteration != 5:
            fail(f"trainer first: latest checkpoint {tag}, iteration {first.iteration}")
        size_mb = os.path.getsize(os.path.join(ckpt_dir, tag + ".pth.tar")) / 1e6
        say(f"trainer first: wrote {tag}.pth.tar ({size_mb:.1f} MB), iteration {first.iteration}")

        second, out2, c2 = run("resumed", 4, "--resume", ckpt_dir)
        check_run(second, out2, headers, first.iteration + 1, [3], "trainer resumed")
        if c2["k1"] != 2 or second.iteration != 7:
            fail(f"trainer resumed: {c2['k1']} K1 launches, iteration {second.iteration}")
        say(f"trainer resumed: started at epoch 3, iteration {first.iteration + 1}, "
            f"as the checkpoint implies")
        steady = [s for s in first.epoch_stats + second.epoch_stats
                  if s["proto_phase"] and s["epoch"] > 1]
        wall = statistics.mean(s["seconds"] / s["steps"] for s in steady)
        wait = statistics.mean(s["loader_wait_s"] / s["steps"] for s in steady)
        say(f"trainer prototype-phase epochs 2-3: wall {1e3 * wall:.1f} ms/step, loader wait "
            f"{1e3 * wait:.1f} ms/step, the rest {1e3 * (wall - wait):.1f} ms/step; the direct "
            f"flagship step's median in this run {direct_ms:.2f} ms")
        del first, second
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {k: c1[k] + c2[k] for k in c1}


def cli_run(torch, trainer_ports, mh, K3, cfg, tmp: str, where: str, name: str, snapshot,
            total: dict, *extra):
    """One training run of the port's CLI on the card: ``cfg`` written as
    YAML and read back through ``--config`` with the flags ``extra``, the
    Trainer built with its output in ``tmp/name``, ``snapshot(state)``
    cloned and the (epoch, iteration) it starts at taken before it trains.
    Prints each epoch's wall time, img/s, peak memory and loader wait, adds
    the launches to ``total``, and fails on any: these runs use the default
    dropout and no MC pass, so no kernel runs. Returns (trainer, snapshot,
    start)."""
    cli, _, _, Trainer = trainer_ports
    path = os.path.join(tmp, name + ".yaml")
    with open(path, "w") as f:
        f.write(cfg.to_yaml())
    reset_counts(mh, K3)
    t0 = time.perf_counter()
    trainer = Trainer(cli.build_config(["--config", path, "--out", os.path.join(tmp, name),
                                        *extra]), "cuda")
    before = {k: v.clone() for k, v in snapshot(trainer.state).items()}
    start = (trainer.epoch, trainer.iteration)
    trainer.train()
    torch.cuda.synchronize()
    launches = counts(mh, K3)
    for k in total:
        total[k] += launches[k]
    for s in trainer.epoch_stats:
        phase = " (prototype phase)" if s["proto_phase"] else ""
        say(f"{where} {name} epoch {s['epoch']}{phase}: wall {s['seconds']:.3f} s for "
            f"{s['steps']} steps, {s['img_per_s']:.2f} img/s, peak memory "
            f"{s['peak_gib']:.2f} GiB, loader wait "
            f"{1e3 * s['loader_wait_s'] / s['steps']:.1f} ms/step")
    say(f"{where} {name}: {time.perf_counter() - t0:.1f} s; launches {launches}")
    if any(launches[k] for k in K13_KEYS):
        fail(f"{where} {name}: kernel launches {launches}, expected no K1 or K3")
    return trainer, before, start


def bank_trainer_phase(torch, np, trainer_ports, cal_prototype, mh, K3) -> dict:
    """``--method prototype --use_TN`` through the port's CLI at full width,
    its bank from ``python -m uda_clr_tpu_torch.tools.cal_prototype
    --synthetic --use_TN`` (in process): 2 epochs with warmup 0 (the second
    in the prototype phase), then ``--resume`` for a third; the resumed run
    must start at the checkpoint's next epoch and iteration with the bank
    it saved. Returns the launch counts of the training runs."""
    cli, _, headers, _ = trainer_ports
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bank_")
    total = {k: 0 for k in counts(mh, K3)}
    try:
        bank_path = os.path.join(tmp, "bank.npz")
        t0 = time.perf_counter()
        cal_prototype.main(["--synthetic", "--use_TN", "--out", bank_path])
        say(f"bank trainer: cal_prototype --synthetic --use_TN wrote {bank_path} in "
            f"{time.perf_counter() - t0:.1f} s")
        cfg = cli.build_config(TRAINER_FLAGS + ["--max-epoch", "2", "--method", "prototype",
                                                "--use_TN"])
        cfg.run.checkpoint_every = 1
        cfg.method.prototype_bank_path = bank_path

        def snapshot(state):  # the bank and the generator, TransNorm buffers included
            return {**state.proto_bank,
                    **{f"gen.{k}": v for k, v in state.gen.state_dict().items()}}

        first, bank0, _ = cli_run(torch, trainer_ports, mh, K3, cfg, tmp, "bank trainer",
                                  "first", snapshot, total)
        check_run(first, os.path.join(tmp, "first"), headers, 0, [0, 1], "bank trainer first")
        if [s["proto_phase"] for s in first.epoch_stats] != [False, True]:
            fail(f"bank trainer first: phases {[s['proto_phase'] for s in first.epoch_stats]}")
        with np.load(bank_path) as f:
            for k in ("bu", "cup", "disc"):
                if not np.array_equal(bank0[k].cpu().numpy(), f[k]):
                    fail(f"bank trainer first: the bank {k!r} is not the tool's")
                if torch.equal(first.state.proto_bank[k].cpu(), bank0[k].cpu()):
                    fail(f"bank trainer first: the prototype phase left the bank {k!r} as it was")
        cfg.run.max_epoch = 3
        second, bank1, start = cli_run(torch, trainer_ports, mh, K3, cfg, tmp, "bank trainer",
                                       "resumed", snapshot, total, "--resume",
                                       os.path.join(tmp, "first", "checkpoints"))
        if start != (2, first.iteration) or [s["epoch"] for s in second.epoch_stats] != [2]:
            fail(f"bank trainer resumed: started at (epoch, iteration) {start}, expected "
                 f"(2, {first.iteration})")
        for k, v in first.state.proto_bank.items():
            if not torch.equal(bank1[k], v):
                fail(f"bank trainer resumed: the loaded bank {k!r} differs from the saved one")
        for k, v in first.state.gen.state_dict().items():  # TransNorm buffers included
            if not torch.equal(bank1[f"gen.{k}"], v):
                fail(f"bank trainer resumed: the loaded generator's {k} differs from the saved one")
        say(f"bank trainer resumed: started at epoch 2, iteration {first.iteration + 1}, "
            f"with the saved bank and generator (TransNorm buffers included), as the "
            f"checkpoint implies")
        del first, second
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return total


# the native host augmentation: NATIVE_SEEDS elastic warps at 512^2 held
# to the scipy path within +/-1 (tests/test_native.py's contract) and the
# share of pixels where they differ bounded. Measured on random uint8
# images (an x86-64 host CPU, g++ -O3 -march=native -ffast-math): any channel
# of the image 0.863-0.872, the label 0.372-0.375 (scipy's uint8 output
# rounds where the native warp truncates, the +/-1 of the contract)
NATIVE_SEEDS = 10
NATIVE_SHARE_BOUND = {"image": 0.90, "label": 0.40}
# the Trainer's image grids: the tags of the JAX package's
# trainer.py:_write_train_images for a flagship step (warmup: the first 13;
# prototype phase: all 17), and the validation strips of the first 8 batches
TRAIN_IMAGE_TAGS = (
    "DomainS/image", "DomainS/target_cup", "DomainS/target_disc", "DomainS/target_boundary",
    "DomainS/prediction_cup", "DomainS/prediction_disc", "DomainS/prediction_boundary",
    "DomainT/image", "DomainT/target_cup", "DomainT/target_disc", "DomainT/prediction_cup",
    "DomainT/prediction_disc", "DomainT/boundaryT",
    "DomainT/target_cup_std_map", "DomainT/target_disc_std_map", "DomainT/mask_0",
    "DomainT/mask_1")
VAL_STRIPS = 8
# evaluation card vs CPU from one checkpoint (float32, TF32 off): the
# metrics differ only where a pixel's probability crosses a threshold; one
# flipped pixel moves a PA by 1/(8 * 512^2) = 4.8e-7 and a Dice by ~1e-6
EVAL_ATOL = 1e-4


def native_phase(np, native, transforms, SyntheticFundus, size: int = 512) -> None:
    """The native library (built with the kernels) on this machine's host:
    the transforms' default path; the elastic warp held to the scipy path on
    NATIVE_SEEDS seeds, the boundary ring equal; ms per sample of each."""
    import scipy.ndimage as ndi

    if os.environ.get(native.ENV_VAR) == "0" or not native.available():
        fail("native: the transforms' default path is not the native library")
    ms = {"native": [], "scipy": []}
    ring_ms = {"native": [], "scipy": []}
    worst = {"image": 0.0, "label": 0.0}
    for seed in range(NATIVE_SEEDS):
        rng = np.random.default_rng(seed)
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        lbl = ((rng.random((size, size)) < 0.3) * 255).astype(np.uint8)
        rx, ry = rng.random((size, size)) * 2 - 1, rng.random((size, size)) * 2 - 1
        mask = np.zeros((size, size, 2), np.uint8)
        mask[size // 4:3 * size // 4, size // 4:3 * size // 4] = 1
        mask[3 * size // 8:5 * size // 8, 3 * size // 8:5 * size // 8, 0] = 1
        out, ring = {}, {}
        for path in ("native", "scipy"):
            native.set_enabled(path == "native")
            t0 = time.perf_counter()
            out[path] = native.elastic(img, lbl, rx, ry, 2.0 * size, 0.08 * size)
            ms[path].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            ring[path] = native.boundary_ring(mask, 5)
            ring_ms[path].append((time.perf_counter() - t0) * 1e3)
        native.set_enabled(True)
        if not np.array_equal(ring["native"], ring["scipy"]):
            fail(f"native: the boundary ring differs from scipy's (seed {seed})")
        dx = ndi.gaussian_filter(rx, 0.08 * size, mode="constant", cval=0) * 2.0 * size
        dy = ndi.gaussian_filter(ry, 0.08 * size, mode="constant", cval=0) * 2.0 * size
        x, y = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        sy, sx = x + dx, y + dy
        band = ((np.abs(sy) < 1e-3) | (np.abs(sy - (size - 1)) < 1e-3)
                | (np.abs(sx) < 1e-3) | (np.abs(sx - (size - 1)) < 1e-3))
        for i, key in enumerate(("image", "label")):
            d = np.abs(out["native"][i].astype(int) - out["scipy"][i].astype(int))
            d = d.max(-1) if d.ndim == 3 else d
            if d[~band].max() > 1:
                fail(f"native: the {key} warp is {d[~band].max()} from scipy's (seed {seed})")
            worst[key] = max(worst[key], float((d > 0).mean()))
    for key, bound in NATIVE_SHARE_BOUND.items():
        if worst[key] > bound:
            fail(f"native: {worst[key]:.4f} of the {key} pixels differ from scipy's "
                 f"(bound {bound})")
    ds = SyntheticFundus(NATIVE_SEEDS, size + 28, transform=transforms.train_transforms(size, "u8"))
    sample_ms = {}
    for path in ("native", "scipy"):
        native.set_enabled(path == "native")
        t0 = time.perf_counter()
        for i in range(NATIVE_SEEDS):
            ds.get(i, np.random.default_rng(i))
        sample_ms[path] = (time.perf_counter() - t0) * 1e3 / NATIVE_SEEDS
    native.set_enabled(True)
    med = {p: statistics.median(v) for p, v in ms.items()}
    ring = {p: statistics.median(v) for p, v in ring_ms.items()}
    say(f"native: elastic {size}^2 within +/-1 of scipy on {NATIVE_SEEDS} seeds, differing "
        f"pixels at most {worst['image']:.4f} (image) and {worst['label']:.4f} (label) "
        f"(bounds {NATIVE_SHARE_BOUND['image']}, {NATIVE_SHARE_BOUND['label']}); boundary "
        f"ring equal")
    say(f"native: ms per sample (median of {NATIVE_SEEDS}, this host): elastic native "
        f"{med['native']:.2f} scipy {med['scipy']:.2f} ({med['scipy'] / med['native']:.2f}x); "
        f"boundary ring native {ring['native']:.2f} scipy {ring['scipy']:.2f}; "
        f"train_transforms({size}, 'u8') native {sample_ms['native']:.2f} scipy "
        f"{sample_ms['scipy']:.2f} ({sample_ms['scipy'] / sample_ms['native']:.2f}x)")


def flagship_cli(torch, trainer_ports, mh, K3, tmp: str, name: str, max_epoch: int,
                 device: str = "cuda", flags=TRAINER_FLAGS, edit=None, before_train=None):
    """The flagship through the CLI's configuration (``flags``,
    ``edit(cfg)``) into ``tmp/name``: the Trainer built as ``cli.main``
    builds it, ``before_train(trainer)`` called, trained; one K1 launch per
    prototype-phase step asserted. Returns (trainer, launches, seconds of
    train())."""
    cli, _, _, Trainer = trainer_ports
    cfg = cli.build_config(flags + ["--max-epoch", str(max_epoch)])
    if edit is not None:
        edit(cfg)
    path = os.path.join(tmp, name.replace(" ", "_") + ".yaml")
    with open(path, "w") as f:
        f.write(cfg.to_yaml())
    out = os.path.join(tmp, name.replace(" ", "_"))
    trainer = Trainer(cli.build_config(["--config", path, "--out", out]), device)
    if before_train is not None:
        before_train(trainer)
    reset_counts(mh, K3)
    t0 = time.perf_counter()
    trainer.train()
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts(mh, K3)
    want = dict.fromkeys(K13_KEYS, 0)
    want["k1"] = sum(s["steps"] for s in trainer.epoch_stats if s["proto_phase"])
    if device == "cuda" and not same_counts(launches, want):
        fail(f"{name}: kernel launches {launches}, expected {want}")
    for s in trainer.epoch_stats:
        phase = "prototype phase" if s["proto_phase"] else "warmup"
        say(f"{name} epoch {s['epoch']} ({phase}): wall {1e3 * s['seconds'] / s['steps']:.1f} "
            f"ms/step, loader wait {1e3 * s['loader_wait_s'] / s['steps']:.1f} ms/step, "
            f"{s['img_per_s']:.2f} img/s")
    return trainer, launches, seconds


def native_trainer_phase(torch, trainer_ports, native, mh, K3, tmp: str, direct_ms: float,
                         device: str = "cuda", flags=TRAINER_FLAGS) -> tuple[dict, str]:
    """The flagship through the CLI, 2 epochs, with each loader backend
    (``thread``, ``process``) and the native library on (the default, first)
    and off; the loader wait and wall per step of each beside the direct
    step. Returns the launches and the checkpoint directory of the first
    run."""
    total, rows, first_out = None, [], None
    for backend in ("thread", "process"):
        for on in (True, False):
            if not on:
                native.set_enabled(False)
            elif not native.available():
                fail("native trainer: the default path is not native")
            name = f"native trainer {backend} native {'on' if on else 'off'}"

            def edit(cfg, backend=backend):
                cfg.data.loader_backend = backend
            try:
                trainer, launches, seconds = flagship_cli(
                    torch, trainer_ports, mh, K3, tmp, name, 2, device, flags, edit)
            finally:
                native.set_enabled(True)
            total = launches if total is None else {k: total[k] + launches[k] for k in total}
            proto = [s for s in trainer.epoch_stats if s["proto_phase"]][-1]
            rows.append((backend, on, 1e3 * proto["loader_wait_s"] / proto["steps"],
                         1e3 * proto["seconds"] / proto["steps"], seconds))
            if first_out is None:
                first_out = trainer.cfg.run.out_dir
            del trainer
    say("native trainer (each run's prototype-phase epoch): " + "; ".join(
        f"{b} native {'on' if on else 'off'}: loader wait {w:.1f} ms/step, wall {wall:.1f} "
        f"ms/step" for b, on, w, wall, _ in rows) + f"; the direct flagship step "
        f"{direct_ms:.2f} ms")
    return total, os.path.join(first_out, "checkpoints")


def images_phase(torch, np, trainer_ports, mh, K3, png, BatchLoader, SyntheticFundus,
                 eval_transforms, tmp: str, device: str = "cuda", flags=TRAINER_FLAGS,
                 size: int = 512) -> dict:
    """The flagship through the CLI, 2 epochs, validating 64 images (8
    batches), without images and with ``viz_every`` 1 and
    ``save_val_images``: every tag file of JAX's ``_write_train_images`` at
    every iteration decodes to its shape, ``visualization/epoch_N.png``
    holds 8 strips; the images' cost per epoch. Tensorboard is kept out
    (where it imports, the Trainer writes its images there instead of to
    PNGs)."""
    saved_tb = sys.modules.get("torch.utils.tensorboard")
    sys.modules["torch.utils.tensorboard"] = None
    try:
        return _images_runs(torch, np, trainer_ports, mh, K3, png, BatchLoader,
                            SyntheticFundus, eval_transforms, tmp, device, flags, size)
    finally:
        if saved_tb is None:
            sys.modules.pop("torch.utils.tensorboard", None)
        else:
            sys.modules["torch.utils.tensorboard"] = saved_tb


def _images_runs(torch, np, trainer_ports, mh, K3, png, BatchLoader, SyntheticFundus,
                 eval_transforms, tmp, device, flags, size) -> dict:
    total, wall = None, {}

    def val64(trainer):
        ds = SyntheticFundus(VAL_STRIPS * 8, size + 28, seed=3,
                             transform=eval_transforms(size, wire=trainer.cfg.data.wire))
        trainer.loader_val = BatchLoader(ds, 8, shuffle=False, drop_last=False,
                                         num_workers=trainer.cfg.data.num_workers)

    for images in (False, True):
        def edit(cfg, images=images):
            cfg.run.viz_every, cfg.run.save_val_images = (1, True) if images else (0, False)

        name = f"images {'on' if images else 'off'}"
        trainer, launches, wall[images] = flagship_cli(
            torch, trainer_ports, mh, K3, tmp, name, 2, device, flags, edit, val64)
        total = launches if total is None else {k: total[k] + launches[k] for k in total}
        out = trainer.cfg.run.out_dir
        if not images:
            continue
        n = 0
        for it in range(trainer.iteration + 1):
            proto = it >= len(trainer.loader_s)  # epoch 0 is warmup, epoch 1 prototype
            for tag in TRAIN_IMAGE_TAGS[:17 if proto else 13]:
                path = os.path.join(out, "tensorboard", "images",
                                    f"{tag.replace('/', '_')}_{it}.png")
                if not os.path.exists(path):
                    fail(f"images: {path} is missing")
                pixels = png.read_png(path)[0]
                # the confidence masks sit at the features' quarter resolution
                side = size // 4 if tag.endswith(("mask_0", "mask_1")) else size
                want = (side, side, 3 if tag.endswith("/image") else 1)
                if pixels.shape != want:
                    fail(f"images: {path} decodes to {pixels.shape}, want {want}")
                n += 1
        for epoch in (0, 1):
            path = os.path.join(out, "visualization", f"epoch_{epoch}.png")
            shape = png.read_png(path)[0].shape if os.path.exists(path) else None
            if shape != (VAL_STRIPS * size, 4 * size, 3):
                fail(f"images: {path} is {shape}, want {VAL_STRIPS} strips of {size}x{4 * size}")
        say(f"images: {n} train-time grid files with JAX's tags at every iteration, "
            f"{VAL_STRIPS} validation strips per epoch in visualization/epoch_N.png, all "
            f"decoding to their shapes")
    say(f"images: cost {(wall[True] - wall[False]) / 2:.2f} s per epoch (train() "
        f"{wall[True]:.2f} s with images, {wall[False]:.2f} s without, 2 epochs of 2 steps "
        f"and 64 validation images)")
    return total


def json_line(main, argv) -> dict:
    """Run a benchmark's or tool's ``main(argv)``, echo what it printed and
    parse its last line, the result."""
    import io

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            main(argv)
    finally:  # a tool that raises has printed why
        say(out.getvalue().rstrip())
    try:
        return json.loads(out.getvalue().strip().splitlines()[-1])
    except (IndexError, ValueError) as e:
        fail(f"{main.__module__}: its last line is not one JSON object ({e})")


def bench_phase(torch, mh, K3, batch_moments, card: str) -> dict:
    """The train-throughput benchmark (``uda_clr_tpu_torch.bench``) at full
    width through its entry point, with the default dropout backend and
    cuDNN's default TF32 setting, as ``python -m uda_clr_tpu_torch.bench``
    runs; checks its JSON line (the keys, ``mfu`` in (0, 1], the card's
    name and power limit) and one K1 launch per prototype-phase step. Then
    K1's flop formula against FlopCounterMode's count of its plain version
    at the main path's shape, and the serving benchmark
    (``uda_clr_tpu_torch.bench_eval``) at batches 8 and 32. Returns the
    train benchmark's launch counts."""
    from uda_clr_tpu_torch import bench, bench_eval
    from uda_clr_tpu_torch.utils.benchmarking import MASK_HEAD_FLOPS_PER_ROW, count_flops

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        reset_counts(mh, K3)
        res = json_line(bench.main, ["--windows", str(BENCH_WINDOWS), "--iters",
                                     str(BENCH_ITERS), "--host-fed-steps",
                                     str(BENCH_HOST_FED_STEPS)])
        launches = counts(mh, K3)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    missing = [k for k in BENCH_KEYS if k not in res]
    if missing:
        fail(f"bench: the JSON line lacks {missing}")
    if not (res["mfu"] is not None and 0.0 < res["mfu"] <= 1.0):
        fail(f"bench: mfu {res['mfu']} is not in (0, 1]")
    if res["device_kind"] != torch.cuda.get_device_name(0) or res["device_kind"] not in card:
        fail(f"bench: device_kind {res['device_kind']!r} does not name the card ({card})")
    if not res["power_limit_w"]:
        fail(f"bench: power_limit_w {res['power_limit_w']}")
    if len(res["step_ms_windows"]) != BENCH_WINDOWS:
        fail(f"bench: {len(res['step_ms_windows'])} windows, want {BENCH_WINDOWS}")
    for key in ("host_fed", "host_fed_f32"):
        row = res[key]
        if not row or not all(row[k] > 0 for k in ("step_ms", "h2d_ms", "load_ms",
                                                     "device_fraction")):
            fail(f"bench: host-fed row {key} {row}")
    expect = {"k1": BENCH_STEPS, "k2": 0, "k3_fwd": 0, "k3_bwd": 0}
    if not same_counts(launches, expect):
        fail(f"bench: kernel launches {launches}, expected {expect} (one K1 per "
             f"prototype-phase step)")
    spread = (res["step_ms_windows"][-1] - res["step_ms_windows"][0]) / res["step_ms_median"]
    say(f"bench: {res['value']} img/s/card, step {res['step_ms_median']} ms, windows "
        f"{res['step_ms_windows']} (spread {spread:.4f} of the median), mfu {res['mfu']} of "
        f"{res['step_tflops']} TFLOP/step, host-fed u8/process {res['host_fed']['step_ms']} "
        f"ms/step, f32/thread {res['host_fed_f32']['step_ms']} ms/step; launches {launches}")

    # K1's formula against its plain version's count, at the main path's shape
    g = torch.Generator("cuda").manual_seed(1)
    x_up, ll, bnd, mean, var = mask_head_inputs(torch, batch_moments, torch.bfloat16, g)
    rand = lambda *sh: torch.randn(*sh, device="cuda", generator=g)
    args = (x_up, ll, bnd, mean, var, 1.0 + 0.2 * rand(305), 0.1 * rand(305),
            0.05 * rand(2, 305, 1, 1), 0.1 * rand(2))
    _, kernel_flops = count_flops(lambda: mh.fused_mask_head_split(*args, seed=3, rate=0.1))
    _, plain_flops = count_flops(lambda: mh.mask_head_plain(*args, seed=3, rate=0.1))
    formula = MASK_HEAD_FLOPS_PER_ROW * math.prod(MAIN_SHAPE)
    say(f"K1 flops at {MAIN_SHAPE}: formula {formula}, counted through the kernel "
        f"{kernel_flops}, FlopCounterMode on the plain version {plain_flops}")
    if not kernel_flops == plain_flops == formula:
        fail("K1's flop formula disagrees with its plain version's count")
    del x_up, ll, bnd, mean, var, args
    torch.cuda.empty_cache()

    ev = json_line(bench_eval.main, ["--batches", BENCH_EVAL_BATCHES])
    if [r["batch"] for r in ev["rows"]] != [int(b) for b in BENCH_EVAL_BATCHES.split(",")]:
        fail(f"bench_eval: rows {ev['rows']}")
    for r in ev["rows"]:
        if "error" in r or not (r["mfu"] is not None and 0.0 < r["mfu"] <= 1.0):
            fail(f"bench_eval: row {r}")
    if ev["device_kind"] != res["device_kind"] or not ev["host_postprocess_ms_per_image"]:
        fail(f"bench_eval: device_kind {ev['device_kind']}, post-processing "
             f"{ev['host_postprocess_ms_per_image']}")
    torch.cuda.empty_cache()
    return launches


def tools_phase(torch, mh, K3, card: str) -> dict:
    """The measurement tools (module docstring, step 3c) through their
    entry points at full width, with fewer windows and steps than their
    defaults, the default dropout backend and cuDNN's default TF32 setting;
    checks the roofline's closure, one K1 launch per prototype-phase step
    of every tool that runs the flagship (none on the plain mask head and
    the slow MC pass), finite losses in the three MC variants, a B 8 row
    that ran and a tn/bn ratio in TN_OVER_BN. Returns the launch counts."""
    import importlib

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    cores = os.cpu_count() or 1
    argv = {
        "roofline_closure": ["--steps", "2", "--out", os.path.join(tmp, "roofline.csv")],
        "bench_norm_ab": ["--windows", "3", "--iters", "3"],
        "bench_batch_scaling": ["--windows", "2", "--iters", "3"],
        "bench_e2e": ["--steps", "3", "--workers", f"1,2,{cores}", "--n-data", "16"],
        "ab_mc_fast": ["--steps", "12", "--out", os.path.join(tmp, "ab_mc_fast.csv")],
        "bench_pipeline": ["--n", "24"],
        "bench_loader_backend": ["--batches", "3", "--out", os.path.join(tmp, "loader.csv")],
    }
    res, launches, seconds = {}, {}, {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for name, args in argv.items():
            module = importlib.import_module(f"uda_clr_tpu_torch.{name}")
            reset_counts(mh, K3)
            t0 = time.perf_counter()
            res[name] = json_line(module.main, args)
            seconds[name] = time.perf_counter() - t0
            launches[name] = counts(mh, K3)
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(tmp, ignore_errors=True)
    for name, r in res.items():
        if r.get("device_kind") != torch.cuda.get_device_name(0) or r["device_kind"] not in card \
                or not r.get("power_limit_w"):
            fail(f"{name}: device_kind {r.get('device_kind')!r}, power_limit_w "
                 f"{r.get('power_limit_w')} do not name the card ({card})")
        if any(launches[name][k] for k in ("k2", "k3_fwd", "k3_bwd")):
            fail(f"{name}: launches {launches[name]} under 'xla16'")
    roof = res["roofline_closure"]
    if roof["checks"] != {**roof["checks"], "flops_conserved": True, "ms_conserved": True,
                          "shares_bounded": True}:
        fail(f"roofline_closure: the closure fails: {roof['checks']}")
    ab = res["ab_mc_fast"]["variants"]
    want_k1 = {
        "roofline_closure": roof["proto_steps"],
        "bench_norm_ab": sum(res["bench_norm_ab"]["proto_steps"].values()),
        "bench_batch_scaling": res["bench_batch_scaling"]["proto_steps"],
        "bench_e2e": res["bench_e2e"]["proto_steps"],
        "ab_mc_fast": res["ab_mc_fast"]["steps"],  # the fast_fused variant's steps alone
        "bench_pipeline": 0,
        "bench_loader_backend": 0,
    }
    for name, k1 in want_k1.items():
        if launches[name]["k1"] != k1:
            fail(f"{name}: K1 launched {launches[name]['k1']} times, expected {k1} (one per "
                 f"prototype-phase step of the flagship)")
    if [ab[v]["k1_launches"] for v in ("fast_fused", "fast_plain", "slow")] != \
            [res["ab_mc_fast"]["steps"], 0, 0]:
        fail(f"ab_mc_fast: K1 launches per variant {[v['k1_launches'] for v in ab.values()]}")
    if not all(v["finite"] for v in ab.values()):
        fail(f"ab_mc_fast: a variant's losses are not finite: {ab}")
    rows = res["bench_batch_scaling"]["rows"]
    if rows[0].get("batch") != 8 or "error" in rows[0] or not 0.0 < rows[0]["mfu"] <= 1.0:
        fail(f"bench_batch_scaling: the B 8 row {rows[0]}")
    ratio = res["bench_norm_ab"]["tn_over_bn"]
    if not TN_OVER_BN[0] <= ratio <= TN_OVER_BN[1]:
        fail(f"bench_norm_ab: tn/bn {ratio} outside {TN_OVER_BN}")
    e2e = res["bench_e2e"]["host_fed"]
    if not e2e or not all(r["step_ms"] > 0 and r["device_fraction"] > 0 for r in e2e):
        fail(f"bench_e2e: rows {e2e}")
    say(f"tools ({card}): roofline {roof['device_ms_per_step']:.2f} device ms/step, "
        f"{roof['attributed_ms_per_step']:.2f} attributed, largest share "
        f"{roof['checks']['max_share']:.3f}; tn/bn {ratio}; batch scaling "
        + ", ".join(f"B{r['batch']} {r.get('img_per_sec_card', r.get('error'))}" for r in rows)
        + " img/s; host-fed " + ", ".join(f"{r['workers']} workers {r['step_ms']} ms"
                                          for r in e2e)
        + f"; seconds per tool {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}")
    return {k: sum(launches[name][k] for name in launches) for k in K13_KEYS + K4_KEYS}


def read_rows(path: str, prefix: str, keys) -> list:
    """The ``<prefix>_<key>`` columns of a longrun CSV, per iteration."""
    with open(path) as f:
        return [{k: float(r[f"{prefix}_{k}"]) for k in keys} for r in csv.DictReader(f)]


def longrun_phase(torch, mh, K3, card: str) -> dict:
    """The long-horizon phase (step 3d) through ``uda_clr_tpu_torch.longrun.main``:
    (a) the flagship at the family's size (64^2, B 2, T=4, float32, TF32
    and dropout off) for 60 iterations on the card, on the CPU and with the
    stem conv x (1 + 1e-6) on the card: finite losses, iteration 0 card
    against CPU within LONGRUN_ITER0_RTOL per key, one K1 launch per
    iteration on the card (the MC head at rate 0), none on the CPU; (b) the
    flagship at full width (512^2, B 8+8, T=8, the u8 wire, all cores'
    loader threads): 100 iterations in bf16 under 'xla16' (K1 at rate 0.1,
    no K3), then 40 in float32 with dropout off, its chaos twin and its
    bf16 twin (dropout off), from the same start: finite losses, one K1
    launch per iteration, and a smoothed loss_all that falls from its first
    window to its last in the bf16 and the float32 run. Prints each gap
    beside the chaos control's. Returns the launch counts."""
    from uda_clr_tpu_torch import longrun

    tmp = tempfile.mkdtemp(prefix="chip_smoke_longrun_")
    keys = longrun.FAMILY["prototype_full"].keys
    cores = str(os.cpu_count() or 1)
    total = dict.fromkeys(K13_KEYS + K4_KEYS, 0)
    try:
        reset_counts(mh, K3)
        t0 = time.perf_counter()
        small = json_line(longrun.main, [
            "--method", "prototype_full", "--device", "cuda", "--iters",
            str(LONGRUN_SMALL_ITERS), "--compare-cpu", "--chaos",
            "--out", os.path.join(tmp, "small.csv")])
        small_s = time.perf_counter() - t0
        got = counts(mh, K3)
        want = {"k1": 2 * LONGRUN_SMALL_ITERS, "k2": 0, "k3_fwd": 0, "k3_bwd": 0}
        runs = small["runs"]
        per_run = [runs[r]["launches"]["k1"] for r in ("port", "cpu", "chaos")]
        if not same_counts(got, want) or per_run != [LONGRUN_SMALL_ITERS, 0, LONGRUN_SMALL_ITERS]:
            fail(f"longrun (a): launches {got}, per run "
                 f"{ {r: v['launches'] for r, v in runs.items()} }, expected one K1 per "
                 f"prototype-phase iteration on the card")
        cpu, chaos = small["gaps"]["cpu"], small["gaps"]["chaos"]
        off = {k: cpu[k]["early"][0] for k in keys if cpu[k]["early"][0] > LONGRUN_ITER0_RTOL}
        if off:
            fail(f"longrun (a): iteration 0 card against CPU {off} > {LONGRUN_ITER0_RTOL}")
        say(f"longrun (a) ({card}), flagship 64^2 B2 T4 float32, {LONGRUN_SMALL_ITERS} "
            f"iterations, {small_s:.1f} s; val Dice card {runs['port']['dice']} CPU "
            f"{runs['cpu']['dice']} chaos {runs['chaos']['dice']}")
        for k in keys:
            say(f"  {k:10s} card vs CPU: smoothed mean {cpu[k]['mean']:.4g} max "
                f"{cpu[k]['max']:.4g}, iterations 0-4 "
                f"{[float(f'{v:.3g}') for v in cpu[k]['early']]} | chaos: smoothed mean "
                f"{chaos[k]['mean']:.4g} max {chaos[k]['max']:.4g}, iterations 0-4 "
                f"{[float(f'{v:.3g}') for v in chaos[k]['early']]}")
        total = {k: total[k] + got[k] for k in total}
        torch.cuda.empty_cache()

        full = ["--method", "prototype_full", "--device", "cuda", "--size", "512", "--batch",
                "8", "--mc-samples", "8", "--wire", "u8", "--workers", cores]
        reset_counts(mh, K3)
        t0 = time.perf_counter()
        bf16 = json_line(longrun.main, full + [
            "--iters", str(LONGRUN_BF16_ITERS), "--dtype", "bfloat16", "--dropout", "xla16",
            "--out", os.path.join(tmp, "bf16.csv")])
        torch.cuda.empty_cache()
        f32 = json_line(longrun.main, full + [
            "--iters", str(LONGRUN_F32_ITERS), "--chaos", "--twin-dtype", "bfloat16",
            "--out", os.path.join(tmp, "f32.csv")])
        full_s = time.perf_counter() - t0
        got = counts(mh, K3)
        want = {"k1": LONGRUN_BF16_ITERS + 3 * LONGRUN_F32_ITERS, "k2": 0, "k3_fwd": 0,
                "k3_bwd": 0}
        if not same_counts(got, want):
            fail(f"longrun (b): launches {got}, expected {want} (one K1 per iteration)")
        for name, res in (("bf16", bf16), ("float32", f32)):
            first, last = res["runs"]["port"]["loss_all_windows"]
            if not last < first:
                fail(f"longrun (b): {name} smoothed loss_all {first} -> {last} does not fall")
        rows16 = read_rows(os.path.join(tmp, "bf16.csv"), "port", keys)[:LONGRUN_F32_ITERS]
        rows32 = read_rows(os.path.join(tmp, "f32.csv"), "port", keys)
        bf_gap = longrun.compare(rows16, rows32, keys)
        f_chaos, f_bf16 = f32["gaps"]["chaos"], f32["gaps"]["bfloat16"]
        say(f"longrun (b) ({card}), flagship 512^2 B8+8 T8: bf16 'xla16' "
            f"{LONGRUN_BF16_ITERS} iterations {bf16['runs']['port']['seconds']:.1f} s, loss_all "
            f"windows {bf16['runs']['port']['loss_all_windows']}, val Dice "
            f"{bf16['runs']['port']['dice']}; float32 {LONGRUN_F32_ITERS} iterations "
            f"{f32['runs']['port']['seconds']:.1f} s, windows "
            f"{f32['runs']['port']['loss_all_windows']}, val Dice {f32['runs']['port']['dice']}"
            f", chaos {f32['runs']['chaos']['dice']}, bf16 twin (dropout off) "
            f"{f32['runs']['bfloat16']['dice']}; loaders {bf16['load_s']:.1f} + "
            f"{f32['load_s']:.1f} s; phase {full_s:.1f} s")
        for k in keys:
            say(f"  {k:10s} bf16 'xla16' vs float32 (first {LONGRUN_F32_ITERS}): smoothed mean "
                f"{bf_gap[k]['mean']:.4g} max {bf_gap[k]['max']:.4g} | bf16 twin, dropout off: "
                f"mean {f_bf16[k]['mean']:.4g} max {f_bf16[k]['max']:.4g} | float32 chaos: "
                f"mean {f_chaos[k]['mean']:.4g} max {f_chaos[k]['max']:.4g}")
        total = {k: total[k] + got[k] for k in total}
    finally:
        longrun.STREAMS.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return total


def eval_phase(torch, np, evaluate, ckpt: str, tmp: str, device: str = "cuda",
               size: int = 512) -> None:
    """``tools/evaluate.py`` on the flagship CLI run's checkpoint over 8
    synthetic images, with ``--postprocess`` and ``--save-viz``, on the
    card and on the CPU: the metrics agree within EVAL_ATOL; ms per image
    of the whole tool and of the eval forward alone."""
    args = ["--checkpoint", ckpt, "--synthetic", "--image-size", str(size), "--batch-size", "8",
            "--postprocess"]
    got, ms = {}, {}
    for where in ("card", "cpu"):
        viz = os.path.join(tmp, f"eval_viz_{where}")
        t0 = time.perf_counter()
        got[where] = evaluate.main(args + ["--save-viz", viz, "--device",
                                           device if where == "card" else "cpu"])
        ms[where] = (time.perf_counter() - t0) * 1e3 / 8
        files = sum(len(fs) for _, _, fs in os.walk(viz))
        if files != 16:
            fail(f"eval {where}: --save-viz wrote {files} files, want 16")
    diff = {k: abs(got["card"][k] - got["cpu"][k]) for k in got["cpu"]}
    say(f"eval: card vs CPU metrics {json.dumps(got['card'])}; largest gap "
        f"{max(diff.values()):.3g} ({max(diff, key=diff.get)}; tolerance {EVAL_ATOL})")
    if max(diff.values()) > EVAL_ATOL or not all(math.isfinite(v) for v in got["card"].values()):
        fail("eval: the card's metrics differ from the CPU's")
    fwd = float("nan")
    if device == "cuda":
        gen = evaluate.load_model(ckpt, False, torch.device(device))
        x = torch.zeros((8, size, size, 3), device=device)
        with torch.no_grad():
            fwd = cuda_ms(lambda: gen(x, train=False), 3, 5)
    say(f"eval: the tool takes {ms['card']:.1f} ms per image on the card ({ms['cpu']:.1f} on "
        f"the CPU), loading, postprocessing and overlays included; its eval forward "
        f"{fwd / 8:.3f} ms per image (batch 8)")


_STANDALONE = """
import io, sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('uda_clr_tpu_torch', 'uda_clr_tpu', 'jax'):
            raise ImportError(name + ' is refused')
sys.meta_path.insert(0, Refuse())
import torch
raw = open(sys.argv[1], 'rb').read()
n = int.from_bytes(raw[4:8], 'little')
model = torch.export.load(io.BytesIO(raw[8 + n:])).module()
out = model(torch.zeros((3, int(sys.argv[2]), int(sys.argv[2]), 3), dtype=torch.uint8,
                        device=sys.argv[3]))
print(*out['mask_probs'].shape, out['mask_probs'].device.type)
"""


def export_phase(torch, np, export, evaluate, ckpt: str, tmp: str, device: str = "cuda",
                 size: int = 512) -> None:
    """``tools/export.py --selftest`` on the checkpoint, f32 and u8, on the
    card; the u8 artifact serves batch 2 and 3 from one program equal to the
    live model, and loads and runs in an interpreter that refuses the port;
    ms per request of 8."""
    gen = evaluate.load_model(ckpt, False, torch.device(device))
    for wire in ("f32", "u8"):
        path = os.path.join(tmp, f"model_{wire}.uda.pt2")
        t0 = time.perf_counter()
        result = export.main(["--checkpoint", ckpt, "--out", path, "--image-size", str(size),
                              "--wire", wire, "--device", device, "--selftest"])
        seconds = time.perf_counter() - t0
        _, program = export.load_artifact(path)
        served = program.module()
        live = export.make_serving_fn(gen, wire)
        errs = []
        for b in (2, 3):
            x = torch.from_numpy(export.selftest_input(wire, b, size, seed=b)).to(device)
            with torch.no_grad():
                errs.append(export.max_abs_err(served(x), live(x)))
        if max(errs) > 1e-6:
            fail(f"export {wire}: the reloaded artifact is {max(errs)} from the live model")
        x8 = torch.from_numpy(export.selftest_input(wire, 8, size, seed=8)).to(device)
        with torch.no_grad():
            req = cuda_ms(lambda: served(x8), 3, 5) if device == "cuda" else float("nan")
            live_ms = cuda_ms(lambda: live(x8), 3, 5) if device == "cuda" else float("nan")
        say(f"export {wire}: {result['bytes'] / 1e6:.1f} MB in {seconds:.1f} s (export, save, "
            f"reload, self-test {result['selftest_max_abs_err']:.3g}); batch 2 and 3 from one "
            f"program within {max(errs):.3g} of the live model; {req:.3f} ms per request of 8 "
            f"(the live model {live_ms:.3f} ms)")
    proc = subprocess.run([sys.executable, "-c", _STANDALONE, path, str(size), device],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or proc.stdout.split() != ["3", str(size), str(size), "2", device]:
        fail(f"export: the payload alone did not serve: {proc.stdout} {proc.stderr[-2000:]}")
    say(f"export: the u8 payload served a batch of 3 on {device} with torch.export.load "
        f"alone, in an interpreter that refuses uda_clr_tpu_torch")


def profiling_phase(torch, np, ports, profiling, mh, K3, tmp: str) -> dict:
    """``utils/profiling.trace`` around two full-width flagship
    prototype-phase steps: a Chrome trace with the card's kernels in it.
    Returns the launch counts."""
    Config, create_train_state, make_train_step, _ = ports
    cfg = full_width_cfg(Config)
    batch = full_width_batch(torch, np)
    state = create_train_state(cfg, seed=0, device="cuda")
    step = make_train_step(cfg, "prototype_full", proto_phase=True)
    state, _ = step(state, batch, 1e-3, 2.5e-5)  # first-call costs out of the trace
    torch.cuda.synchronize()
    reset_counts(mh, K3)
    out = os.path.join(tmp, "profile")
    with profiling.trace(out):
        for _ in range(2):
            with profiling.annotate("flagship_step"):
                state, m = step(state, batch, 1e-3, 2.5e-5)
    launches = counts(mh, K3)
    path = os.path.join(out, "trace.json")
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    marks = sum(1 for e in events if e.get("name") == "flagship_step")
    say(f"profiling: {path} {os.path.getsize(path) / 1e6:.1f} MB, {len(events)} events, "
        f"{kernels} card kernels, {marks} annotated steps; launches {launches}")
    if kernels == 0 or marks < 2 or launches["k1"] != 2:
        fail("profiling: the trace holds no card kernel or annotation, or K1 did not run")
    del state, batch
    torch.cuda.empty_cache()
    return launches


# ---- data parallelism: two ranks on the one card ------------------------


def dp_batch(torch, np, rank: int, world: int, device: str = "cuda") -> dict:
    """This rank's rows of the full-width global batch (8 + 8 at 512^2);
    on the ('data', 'space') mesh its data index's rows and its stripe of
    every image."""
    from uda_clr_tpu_torch.parallel import spatial
    from uda_clr_tpu_torch.parallel.mesh import local_rows, local_stripe

    arrs = small_batch(np, np.random.default_rng(0), 8, 512)
    (d, n_data), (s, n_space) = spatial.data_coords(), spatial.space_coords()
    if spatial.mesh() is None:
        d, n_data = rank, world
    rows, stripe = local_rows(8, d, n_data), local_stripe(512, s, n_space)
    return {k: torch.from_numpy(v[rows, stripe].copy()).to(device) for k, v in arrs.items()}


def dp_equivalence_step(torch, np, ports, norm: str, rank: int = 0, world: int = 1,
                        method: str = "prototype_full") -> dict:
    """One ``method`` step at full width in float32, dropout off, on this
    rank's rows (``prototype_full``: a prototype-phase step; ``baseline``:
    the source alone, a one-domain batch); its metrics, the generator's
    running stats and parameters after the step and the banks, on the
    CPU."""
    Config, create_train_state, make_train_step, layers = ports
    cfg = Config()
    cfg.method.mc_samples = 8
    cfg.model.norm = norm
    from uda_clr_tpu_torch.ops import dropout as K3
    from uda_clr_tpu_torch.ops import mask_head as mh

    where = f"data-parallel {method} step ({norm}, rank {rank} of {world})"
    layers.set_dropout_impl("off")
    try:
        state = create_train_state(cfg, seed=0, device="cuda", method=method)
        reset_counts(mh, K3)
        t0 = time.perf_counter()
        state, m = make_train_step(cfg, method, proto_phase=True)(
            state, dp_batch(torch, np, rank, world), DP_LR, 2.5e-5)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        layers.set_dropout_impl("xla16")
    check_counts(mh, K3, {"k1": int(method == "prototype_full"), "k2": 0, "k3_fwd": 0,
                          "k3_bwd": 0}, where)
    take_viz(m, where)
    check_metrics(m, where)
    cpu = lambda tree: {k: v.detach().cpu().clone() for k, v in tree.items()}
    out = {"metrics": {k: float(v) for k, v in m.items()}, "ms": ms,
           "launches": counts(mh, K3),
           "buffers": cpu(dict(state.gen.named_buffers())),
           "params": cpu(dict(state.gen.named_parameters())),
           "banks": cpu({"proto_src": state.proto_src, "proto_trg": state.proto_trg})}
    del state
    torch.cuda.empty_cache()
    return out


def dp_flagship_timing(torch, np, ports, mh, K3, rank: int, world: int) -> dict:
    """The flagship's bf16 step (default dropout) on this rank's rows:
    1 warmup + 3 prototype-phase steps, one K1 launch per prototype step;
    the median of steps 1-2 and the peak device memory of the four."""
    Config, create_train_state, make_train_step, _ = ports
    cfg = full_width_cfg(Config)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, seed=0, device="cuda")
    batch = dp_batch(torch, np, rank, world)
    warm = make_train_step(cfg, "prototype_full", proto_phase=False)
    proto = make_train_step(cfg, "prototype_full", proto_phase=True)
    reset_counts(mh, K3)
    state, m = warm(state, batch, 1e-3, 2.5e-5)
    take_viz(m, f"rank {rank} flagship warmup")
    step_ms = []
    calls = {}
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the last step counts its collectives (all-reduces, halo exchanges)
        with counted_collectives(calls) if i == 2 else contextlib.nullcontext():
            state, m = proto(state, batch, 1e-3, 2.5e-5)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        take_viz(m, f"rank {rank} flagship step {i}")
        check_metrics(m, f"rank {rank} flagship step {i}")
    check_counts(mh, K3, {"k1": 3, "k2": 0, "k3_fwd": 0, "k3_bwd": 0},
                 f"rank {rank} flagship (bf16, 'xla16')")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    torch.cuda.empty_cache()
    return {"ms": statistics.median(step_ms[1:]), "peak_gib": peak, "launches": counts(mh, K3),
            "collectives": calls}


@contextlib.contextmanager
def counted_collectives(calls: dict):
    """Count the ``torch.distributed`` all-reduces and batched sends and
    receives (the halo exchanges) made inside the block into ``calls``."""
    import torch.distributed as dist

    real = {name: getattr(dist, name) for name in ("all_reduce", "batch_isend_irecv")}

    def counting(name):
        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return real[name](*args, **kwargs)
        return call

    for name in real:
        setattr(dist, name, counting(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def dp_pallas_steps(torch, np, ports, mh, K3, rank: int, world: int) -> dict:
    """``prototype_mt`` under the fused dropout kernel, 2 prototype-phase
    steps at full width (bf16) on this rank's rows: K1 once and K3 at 8
    forward and 4 backward sites per step; the keep mask of the first K3
    launch of each step, drawn again from its seed on a tensor of ones
    (that launch is uncounted), as a digest."""
    import hashlib

    Config, create_train_state, make_train_step, layers = ports
    cfg = full_width_cfg(Config)
    state = create_train_state(cfg, seed=0, device="cuda", method="prototype_mt")
    batch = dp_batch(torch, np, rank, world)
    step = make_train_step(cfg, "prototype_mt", proto_phase=True)
    launched, real = [], K3.launch

    def spy(x, seed, rate):
        launched.append((tuple(x.shape), x.dtype, seed, rate))
        return real(x, seed, rate)

    sites = K3_SITES_PER_FORWARD
    layers.set_dropout_impl("pallas")
    K3.launch = spy
    reset_counts(mh, K3)
    firsts = []
    try:
        for i in range(2):
            del launched[:]
            state, m = step(state, batch, 1e-3, 2.5e-5)
            torch.cuda.synchronize()
            take_viz(m, f"rank {rank} prototype_mt 'pallas' step {i}")
            check_metrics(m, f"rank {rank} prototype_mt 'pallas' step {i}")
            firsts.append(launched[0])
            check_counts(mh, K3, {"k1": i + 1, "k2": 0, "k3_fwd": (i + 1) * 2 * sites,
                                  "k3_bwd": (i + 1) * sites},
                         f"rank {rank} prototype_mt 'pallas' step {i}")
    finally:
        K3.launch = real
        layers.set_dropout_impl("xla16")
    launches = counts(mh, K3)
    digests = []
    for shape, dtype, seed, rate in firsts:
        keep = real(torch.ones(shape, dtype=dtype, device="cuda"), seed, rate) != 0
        digests.append(hashlib.sha256(np.packbits(keep.cpu().numpy()).tobytes()).hexdigest())
    del state
    torch.cuda.empty_cache()
    return {"launches": launches, "mask_digests": digests,
            "keep_share": float(keep.float().mean())}


def dp_rank(spec: dict) -> None:
    """A rank of the data-parallel or the spatial phase (``chip_smoke.py
    --dp-rank JSON``): joins the gloo group (and, with ``spec['n_space']``
    above 1, the ``('data', 'space')`` mesh), runs the float32 equivalence
    step under bn and tn, the bf16 flagship timing and, with
    ``spec['pallas']``, ``prototype_mt`` under 'pallas' on its rows (and
    stripe), and writes the results to ``spec['out']``."""
    import numpy as np
    import torch

    from uda_clr_tpu_torch.config import Config
    from uda_clr_tpu_torch.models import layers
    from uda_clr_tpu_torch.ops import dropout as K3
    from uda_clr_tpu_torch.ops import mask_head as mh
    from uda_clr_tpu_torch.parallel import distributed as dist_lib
    from uda_clr_tpu_torch.parallel import spatial
    from uda_clr_tpu_torch.train.state import create_train_state
    from uda_clr_tpu_torch.train.steps import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = spec["rank"], spec["world"]
    ports = (Config, create_train_state, make_train_step, layers)
    dist_lib.initialize(spec["init"], world, rank, backend="gloo", device="cuda")
    try:
        torch.cuda.set_device(dist_lib.rank_device("cuda"))
        n_space = spec.get("n_space", 1)
        spatial.init_mesh((world // n_space, n_space))
        out = {"equivalence": {norm: dp_equivalence_step(torch, np, ports, norm, rank, world)
                               for norm in ("bn", "tn")}}
        if spec.get("baseline_tn"):
            out["equivalence"]["baseline-tn"] = dp_equivalence_step(
                torch, np, ports, "tn", rank, world, "baseline")
        out["flagship"] = dp_flagship_timing(torch, np, ports, mh, K3, rank, world)
        if spec.get("pallas", True):
            out["pallas"] = dp_pallas_steps(torch, np, ports, mh, K3, rank, world)
        dist_lib.barrier()
    finally:
        dist_lib.shutdown()
    torch.save(out, spec["out"])


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(commands: list, tmp: str, name: str) -> list:
    """Start one process per rank (``commands[r]``), all at once, and wait;
    a rank that exits non-zero fails the phase (the others are stopped).
    Returns each rank's standard output."""
    logs = [os.path.join(tmp, f"{name}_rank{r}.log") for r in range(len(commands))]
    procs = []
    for cmd, log in zip(commands, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                          cwd=os.path.dirname(os.path.abspath(__file__))))
    deadline = time.monotonic() + DP_RANK_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            dead = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if dead or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outputs = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as f:
            outputs.append(f.read())
        if p.returncode != 0:
            fail(f"{name}: rank {r} exited with {p.returncode}:\n{outputs[r][-4000:]}")
    return outputs


def dp_compare(single: dict, ranks: list, norm: str, what: str = "data-parallel",
               tight=DP_TIGHT, loose=DP_LOOSE) -> dict:
    """The ranks' equivalence step against the one-process step: every gap,
    failing on one past its tolerance; the ranks must agree bit for bit.
    ``tight`` and ``loose``: the step's metrics by class."""
    import torch

    where = f"{what} equivalence ({norm})"
    r0 = ranks[0]
    for r, res in enumerate(ranks[1:], 1):
        if res["metrics"] != r0["metrics"]:
            fail(f"{where}: rank {r}'s metrics differ from rank 0's")
        for part in ("params", "buffers", "banks"):
            if any(not torch.equal(res[part][k], r0[part][k]) for k in r0[part]):
                fail(f"{where}: rank {r}'s {part} differ from rank 0's")
    if set(single["metrics"]) != set(tight + loose) or set(r0["metrics"]) != set(
            single["metrics"]):
        fail(f"{where}: metrics {sorted(r0['metrics'])} vs {sorted(single['metrics'])}")
    gaps = {}
    for keys, tol in ((tight, DP_TIGHT_ATOL), (loose, DP_LOOSE_ATOL)):
        for k in keys:
            gaps[k] = abs(single["metrics"][k] - r0["metrics"][k])
            say(f"{where} {k}: one process {single['metrics'][k]:.8g}, {len(ranks)} ranks "
                f"{r0['metrics'][k]:.8g}, gap {gaps[k]:.3e} (tolerance {tol:g})")
            if not gaps[k] <= tol:
                fail(f"{where}: {k} gap {gaps[k]:.3e} > {tol:g}")
    gaps["stats"] = max(float((v - r0["buffers"][k]).abs().max()) / max(float(v.abs().max()), 1e-3)
                        for k, v in single["buffers"].items())
    d = torch.cat([(v - r0["params"][k]).abs().flatten() for k, v in single["params"].items()])
    gaps["params_median_lr"] = float(d.median()) / DP_LR
    gaps["params_max_lr"] = float(d.max()) / DP_LR
    gaps["banks"] = max(float((v - r0["banks"][k]).abs().max()) for k, v in single["banks"].items())
    say(f"{where}: running stats {gaps['stats']:.3e} of their largest entry (tolerance "
        f"{DP_STATS_RTOL:g}); parameters median {gaps['params_median_lr']:.3g} lr (tolerance "
        f"{DP_PARAM_MEDIAN_LR:g}), largest {gaps['params_max_lr']:.3g} lr (Adam's first step: "
        f"<= 2); banks {gaps['banks']:.3e} (tolerance {DP_BANK_ATOL:g})")
    if not gaps["stats"] <= DP_STATS_RTOL:
        fail(f"{where}: running stats gap {gaps['stats']:.3e}")
    if not gaps["params_median_lr"] <= DP_PARAM_MEDIAN_LR or not gaps["params_max_lr"] <= 2.01:
        fail(f"{where}: parameters gap {gaps['params_median_lr']:.3g} / "
             f"{gaps['params_max_lr']:.3g} lr")
    if not gaps["banks"] <= DP_BANK_ATOL:
        fail(f"{where}: banks gap {gaps['banks']:.3e}")
    return gaps


def dp_trainer_yaml(build_config, tmp: str, rank: int, port: int, max_epoch: int,
                    world: int = DP_WORLD, mesh_shape=None) -> str:
    """Rank ``rank``'s ``--config`` YAML of the CLI run in ``world`` ranks
    (on ``mesh_shape``)."""
    cfg = build_config(TRAINER_FLAGS + ["--max-epoch", str(max_epoch)])
    cfg.data.synthetic_size = 16  # 2 global steps of 8 + 8 per epoch
    cfg.method.warmup_epoch = 0  # epoch 0 warmup, then the prototype phase
    cfg.run.checkpoint_every = 1
    cfg.run.dist_coordinator = f"localhost:{port}"
    cfg.run.dist_num_processes, cfg.run.dist_process_id = world, rank
    cfg.run.dist_backend = "gloo"  # nccl refuses two ranks on one card
    cfg.run.mesh_shape = mesh_shape
    path = os.path.join(tmp, f"trainer_rank{rank}_{max_epoch}.yaml")
    with open(path, "w") as f:
        f.write(cfg.to_yaml())
    return path


def dp_summaries(outputs: list, where: str, world: int = DP_WORLD) -> list:
    summaries = []
    for r, text in enumerate(outputs):
        lines = [l for l in text.splitlines() if l.startswith("rank summary: ")]
        if len(lines) != 1:
            fail(f"{where}: rank {r} printed {len(lines)} summary lines:\n{text[-3000:]}")
        summaries.append(json.loads(lines[0][len("rank summary: "):]))
    for r, s in enumerate(summaries):
        if s["rank"] != r or s["world"] != world or s["replica_gap"] != 0.0:
            fail(f"{where}: rank {r}'s summary {s}")
    return summaries


def dp_trainer_phase(build_config, headers, tmp: str, world: int = DP_WORLD, mesh_shape=None,
                     resume: bool = True, what: str = "data-parallel") -> dict:
    """The CLI in ``world`` ranks on the card (on ``mesh_shape``), one
    ``python -m uda_clr_tpu_torch.cli --config`` per rank: 2 epochs
    (warmup, prototype phase), then with ``resume`` a resume in as many
    ranks for a third. Returns the launches and the ranks' step ms and
    loader wait of the prototype-phase epochs."""
    run = os.path.join(tmp, f"{what}_run")
    total = dict.fromkeys(K13_KEYS + K4_KEYS, 0)
    stats = []
    runs = [(2, [])] + ([(3, ["--resume", os.path.join(run, "checkpoints")])] if resume else [])
    for max_epoch, extra in runs:
        port = free_port()
        commands = [[sys.executable, "-m", "uda_clr_tpu_torch.cli", "--config",
                     dp_trainer_yaml(build_config, tmp, r, port, max_epoch, world, mesh_shape),
                     "--out", run, *extra] for r in range(world)]
        t0 = time.perf_counter()
        where = f"{what} CLI to epoch {max_epoch}"
        summaries = dp_summaries(run_ranks(commands, tmp, f"{what}_trainer{max_epoch}"), where,
                                 world)
        say(f"{where}: {time.perf_counter() - t0:.1f} s for the {world} ranks")
        want_epochs = [0, 1] if not extra else [2]
        for r, s in enumerate(summaries):
            epochs = s["epochs"]
            if [e["epoch"] for e in epochs] != want_epochs:
                fail(f"{where}: rank {r} trained epochs {[e['epoch'] for e in epochs]}")
            proto_steps = sum(e["steps"] for e in epochs if e["proto_phase"])
            if not same_counts(s["launches"], {"k1": proto_steps, "k3_fwd": 0, "k3_bwd": 0}):
                fail(f"{where}: rank {r} launches {s['launches']}, want one K1 launch per "
                     f"prototype-phase step ({proto_steps})")
            for k in total:
                total[k] += s["launches"].get(k, 0)
            for e in epochs:
                phase = "prototype phase" if e["proto_phase"] else "warmup"
                say(f"{where} rank {r} epoch {e['epoch']} ({phase}): wall "
                    f"{1e3 * e['seconds'] / e['steps']:.1f} ms/step, {e['img_per_s']:.2f} img/s "
                    f"(global), loader wait {1e3 * e['loader_wait_s'] / e['steps']:.1f} ms/step, "
                    f"peak {e['peak_gib'] or 0.0:.2f} GiB")
                if e["proto_phase"]:
                    stats.append({"rank": r, "epoch": e["epoch"],
                                  "ms": 1e3 * e["seconds"] / e["steps"],
                                  "wait_ms": 1e3 * e["loader_wait_s"] / e["steps"],
                                  "img_per_s": e["img_per_s"], "peak_gib": e["peak_gib"]})
    # one writer: one log.csv (the header, 2 steps + 1 validation per
    # epoch), one checkpoint set, no stray file
    epochs = len(runs) + 1
    with open(os.path.join(run, "log.csv")) as f:
        rows = list(csv.reader(f))
    train = [r for r in rows[1:] if r[2]]
    if rows[0] != headers or len(rows) != 1 + 3 * epochs or \
            [int(r[1]) for r in train] != list(range(2 * epochs)):
        fail(f"{what} CLI: log.csv has {len(rows)} rows, train iterations "
             f"{[r[1] for r in train]}")
    want = sorted(f"checkpoint_{e}.{x}" for e in range(1, epochs + 1)
                  for x in ("meta.json", "pth.tar"))
    if sorted(os.listdir(os.path.join(run, "checkpoints"))) != want:
        fail(f"{what} CLI: checkpoints {sorted(os.listdir(os.path.join(run, 'checkpoints')))}")
    say(f"{what} CLI: one log.csv ({len(rows)} rows) and one checkpoint set {want}, "
        f"written by rank 0; parameters equal bit for bit across ranks after each run")
    return {"launches": total, "stats": stats}


def dp_phase(torch, np, ports, build_config, headers, flagship_ms: float, card: str) -> tuple:
    """Data parallelism in two gloo ranks on the one card (module docstring,
    step 16). Returns the launches of every rank's main paths and the
    one-process equivalence steps."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        single = {norm: dp_equivalence_step(torch, np, ports, norm) for norm in ("bn", "tn")}
        single["baseline-tn"] = dp_equivalence_step(torch, np, ports, "tn", method="baseline")
        init = f"file://{os.path.join(tmp, 'dist_init')}"
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(DP_WORLD)]
        commands = [[sys.executable, os.path.abspath(__file__), "--dp-rank", json.dumps(
            {"rank": r, "world": DP_WORLD, "init": init, "out": outs[r], "baseline_tn": True})]
            for r in range(DP_WORLD)]
        t0 = time.perf_counter()
        run_ranks(commands, tmp, "steps")
        say(f"data-parallel steps: {time.perf_counter() - t0:.1f} s for both ranks")
        ranks = [torch.load(o, weights_only=False) for o in outs]
        for norm in ("bn", "tn"):
            dp_compare(single[norm], [r["equivalence"][norm] for r in ranks], norm)
        # TransNorm splits the baseline's source-only batch over the global
        # batch, whose first half each rank's rows lie in wholly or not at all
        dp_compare(single["baseline-tn"], [r["equivalence"]["baseline-tn"] for r in ranks],
                   "tn", what="data-parallel baseline", tight=("loss_seg", "loss_all"), loose=())
        digests = [r["pallas"]["mask_digests"] for r in ranks]
        for i in range(2):
            if digests[0][i] == digests[1][i]:
                fail(f"prototype_mt 'pallas' step {i}: the ranks drew the same K3 mask")
        say(f"prototype_mt 'pallas' in {DP_WORLD} ranks: launches per rank "
            f"{[r['pallas']['launches'] for r in ranks]}; first K3 mask per step differs "
            f"between the ranks ({[d[:12] for d in digests]}), keep share "
            f"{ranks[0]['pallas']['keep_share']:.4f}")
        trainer = dp_trainer_phase(build_config, headers, tmp)
        runs = [*single.values()] + [r["equivalence"][n] for r in ranks
                                     for n in ("bn", "tn", "baseline-tn")] \
            + [r[part] for r in ranks for part in ("flagship", "pallas")]
        launches = {k: sum(run["launches"][k] for run in runs) + trainer["launches"][k]
                    for k in K13_KEYS + K4_KEYS}
        rank_ms = [r["flagship"]["ms"] for r in ranks]
        beside = "not measured in this run" if flagship_ms is None else (
            f"{flagship_ms:.2f} ms for 8 + 8 ({8 / (flagship_ms / 1e3):.2f} img/s)")
        say(f"data-parallel flagship step (bf16, 'xla16'; {card}): rank medians "
            f"{', '.join(f'{ms:.2f}' for ms in rank_ms)} ms for 4 + 4 images each, "
            f"{8 / (max(rank_ms) / 1e3):.2f} global img/s (source images), beside the "
            f"one-process step: {beside}. Two ranks share one card through gloo: not a "
            f"scaling figure")
        for s in trainer["stats"]:
            say(f"data-parallel CLI prototype-phase epoch {s['epoch']} rank {s['rank']}: "
                f"{s['ms']:.1f} ms/step, loader wait {s['wait_ms']:.1f} ms/step, "
                f"{s['img_per_s']:.2f} global img/s ({card}; two ranks on one card)")
        say(f"data-parallel phase launches (all ranks): {launches}")
        return launches, single
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def spatial_phase(torch, np, ports, build_config, headers, card: str, single=None) -> dict:
    """The ('data', 'space') mesh on the one card (module docstring, step
    17): ranks on each of SPATIAL_MESHES sharing the card through gloo, the
    halo rows staged through the host. ``single``: the one-process float32
    equivalence steps of the data-parallel phase (run here without it).
    Returns the launches of every path it drove."""
    from uda_clr_tpu_torch.ops import dropout as K3
    from uda_clr_tpu_torch.ops import mask_head as mh

    tmp = tempfile.mkdtemp(prefix="chip_smoke_spatial_")
    try:
        t_phase = time.perf_counter()
        runs = []
        if single is None:
            single = {norm: dp_equivalence_step(torch, np, ports, norm) for norm in ("bn", "tn")}
            runs += single.values()
        one = dp_flagship_timing(torch, np, ports, mh, K3, 0, 1)
        runs.append(one)
        for n_data, n_space in SPATIAL_MESHES:
            world, shape = n_data * n_space, f"({n_data}, {n_space})"
            init = f"file://{os.path.join(tmp, f'init{n_data}x{n_space}')}"
            outs = [os.path.join(tmp, f"rank{n_data}x{n_space}_{r}.pt") for r in range(world)]
            pallas = (n_data, n_space) == SPATIAL_MESHES[0]
            commands = [[sys.executable, os.path.abspath(__file__), "--dp-rank", json.dumps(
                {"rank": r, "world": world, "n_space": n_space, "init": init, "out": outs[r],
                 "pallas": pallas})] for r in range(world)]
            t0 = time.perf_counter()
            run_ranks(commands, tmp, f"spatial{n_data}x{n_space}")
            say(f"spatial mesh {shape}: {time.perf_counter() - t0:.1f} s for its {world} ranks")
            ranks = [torch.load(o, weights_only=False) for o in outs]
            for norm in ("bn", "tn"):
                dp_compare(single[norm], [r["equivalence"][norm] for r in ranks], norm,
                           f"spatial mesh {shape}")
            runs += [r["equivalence"][n] for r in ranks for n in ("bn", "tn")]
            runs += [r["flagship"] for r in ranks]
            if pallas:
                digests = [r["pallas"]["mask_digests"] for r in ranks]
                for i in range(2):
                    if len({d[i] for d in digests}) != world:
                        fail(f"spatial mesh {shape} prototype_mt 'pallas' step {i}: two ranks "
                             f"drew the same K3 mask")
                runs += [r["pallas"] for r in ranks]
                say(f"spatial mesh {shape} prototype_mt 'pallas': launches per rank "
                    f"{[r['pallas']['launches'] for r in ranks]}; first K3 mask per step "
                    f"differs between the ranks")
            say(f"spatial mesh {shape} flagship step (bf16, 'xla16'; {card}): " + "; ".join(
                f"rank {r} {res['flagship']['ms']:.2f} ms, peak "
                f"{res['flagship']['peak_gib']:.2f} GiB, K1 {res['flagship']['launches']['k1']} "
                f"launches in 3 prototype-phase steps, collectives in one step "
                f"{res['flagship']['collectives']}" for r, res in enumerate(ranks))
                + f"; one process {one['ms']:.2f} ms, peak {one['peak_gib']:.2f} GiB (8 + 8 "
                f"images). The ranks share one card through gloo: not a scaling figure")
        trainer = dp_trainer_phase(build_config, headers, tmp, 2, SPATIAL_MESHES[0], False,
                                   "spatial")
        for st in trainer["stats"]:
            say(f"spatial CLI {SPATIAL_MESHES[0]} prototype-phase epoch {st['epoch']} rank "
                f"{st['rank']}: {st['ms']:.1f} ms/step, loader wait {st['wait_ms']:.1f} ms/step, "
                f"peak {st['peak_gib']:.2f} GiB ({card})")
        launches = {k: sum(run["launches"][k] for run in runs) + trainer["launches"][k]
                    for k in K13_KEYS + K4_KEYS}
        say(f"spatial phase launches (all ranks): {launches}; "
            f"{time.perf_counter() - t_phase:.1f} s")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_counts(mh, K3, expect: dict, where: str) -> None:
    """Fail unless the launches equal ``expect`` on its keys, which name
    K1/K2 and K3 always and K4's entries where the path knows its norm
    sites."""
    got = counts(mh, K3)
    if not set(K13_KEYS) <= set(expect) or not same_counts(got, expect):
        fail(f"{where}: kernel launches {got}, expected {expect}")


def take_viz(m: dict, where: str, device: str = "cuda") -> dict:
    """Pop the step's ``_viz`` tiles (the Trainer's image grids) and check
    them: finite [H, W, C] float32 tiles on ``device``."""
    import torch

    tiles = m.pop("_viz", None)
    if not tiles or not {"pred_s", "pred_b_s"} <= set(tiles):
        fail(f"{where}: the step returned no _viz tiles ({tiles and sorted(tiles)})")
    for k, v in tiles.items():
        if v.dim() != 3 or v.dtype != torch.float32 or v.device.type != device \
                or not bool(v.isfinite().all()):
            fail(f"{where}: _viz tile {k} {tuple(v.shape)} {v.dtype} on {v.device} is not a "
                 f"finite float32 tile")
    return tiles


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

        from uda_clr_tpu_torch import cli
        from uda_clr_tpu_torch.config import Config
        from uda_clr_tpu_torch.data import native, png, transforms, wire
        from uda_clr_tpu_torch.data.pipeline import BatchLoader
        from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
        from uda_clr_tpu_torch.data.transforms import eval_transforms
        from uda_clr_tpu_torch.models import layers
        from uda_clr_tpu_torch.models.deeplab import DeepLab
        from uda_clr_tpu_torch.models.norm import DomainNorm2d, batch_moments
        from uda_clr_tpu_torch.ops import cuda_build
        from uda_clr_tpu_torch.ops import domain_norm as K4
        from uda_clr_tpu_torch.ops import dropout as K3
        from uda_clr_tpu_torch.ops import mask_head as mh
        from uda_clr_tpu_torch.tools import cal_prototype, evaluate, export
        from uda_clr_tpu_torch.train import checkpoint as ckpt_lib
        from uda_clr_tpu_torch.train.state import create_train_state
        from uda_clr_tpu_torch.train.steps import kernel_seed, make_train_step
        from uda_clr_tpu_torch.train.trainer import Trainer
        from uda_clr_tpu_torch.utils import profiling
        from uda_clr_tpu_torch.utils.logging import LOG_HEADERS
    except ImportError as e:
        fail(f"the port's package is not importable from here ({e}); run from the repo root")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ports = (Config, create_train_state, make_train_step, layers)

    card = card_line()
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libraries = (mh.LIBRARY, K3.LIBRARY, K4.LIBRARY, native.LIBRARY)
    cuda_build.build_all(libraries)
    say(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{', '.join(lib.source.name for lib in libraries)} (nvcc for sm_90a and g++ "
        f"{' '.join(cuda_build.CXXFLAGS)}, in parallel)")
    for lib in libraries:
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {lib.source.name}: {line.strip()}")

    if "--dp-only" in sys.argv[1:]:
        dp_phase(torch, np, ports, cli.build_config, LOG_HEADERS, None, card)
        say("chip_smoke --dp-only: the data-parallel phase passed")
        return
    if "--spatial-only" in sys.argv[1:]:
        spatial_phase(torch, np, ports, cli.build_config, LOG_HEADERS, card)
        say("chip_smoke --spatial-only: the spatial-mesh phase passed")
        return
    if "--bench-only" in sys.argv[1:]:
        bench_phase(torch, mh, K3, batch_moments, card)
        say("chip_smoke --bench-only: the bench phase passed")
        return
    if "--tools-only" in sys.argv[1:]:
        tools_phase(torch, mh, K3, card)
        say("chip_smoke --tools-only: the tools phase passed")
        return
    if "--norm-only" in sys.argv[1:]:
        norm_phase(torch, F, K4)
        say("chip_smoke --norm-only: the K4 phase passed")
        return
    if "--longrun-only" in sys.argv[1:]:
        longrun_phase(torch, mh, K3, card)
        say("chip_smoke --longrun-only: the long-horizon phase passed")
        return
    mask_numbers = kernel_phase(torch, mh, batch_moments, kernel_seed)
    k3_numbers = dropout_phase(torch, F, K3)
    k4_numbers = norm_phase(torch, F, K4)
    small_parity_phase(torch, np, ports)
    benched = bench_phase(torch, mh, K3, batch_moments, card)
    tooled = tools_phase(torch, mh, K3, card)
    longran = longrun_phase(torch, mh, K3, card)

    # the flagship path: K1 once per prototype-phase step, no K3 under 'xla16'
    flagship_info: dict = {}
    flagship, flagship_ms = prototype_path(torch, np, ports, mh, K3, "prototype_full", {
        "warmup": {}, "proto": {"k1": 1}}, info=flagship_info, norm_suffix=MC_SUFFIX_NORMS)
    # the paper's full method under the fused dropout kernel
    sites = K3_SITES_PER_FORWARD
    layers.set_dropout_impl("pallas")
    try:
        mt, _ = prototype_path(torch, np, ports, mh, K3, "prototype_mt", {
            "warmup": {"k3_fwd": sites, "k3_bwd": sites},
            "proto": {"k1": 1, "k3_fwd": 2 * sites, "k3_bwd": sites}})
    finally:
        layers.set_dropout_impl("xla16")
    # TransNorm: the standalone fast MC forward (degenerate TN prefix), K1
    # once per prototype step with doubled coefficients
    to_tn = lambda c: setattr(c.model, "norm", "tn")
    flagship_tn, tn_ms = prototype_path(torch, np, ports, mh, K3, "prototype_full", {
        "warmup": {}, "proto": {"k1": 1}}, name="prototype_full tn", steps=4, configure=to_tn)
    bank = bank_tool_phase(torch, np, (cal_prototype.compute_prototypes, DeepLab, DomainNorm2d,
                                       SyntheticFundus, eval_transforms, BatchLoader))
    bank_keys = {"loss_seg", "loss_adv", "loss_cup", "loss_disc", "loss_all", "loss_D", "loss_D2"}

    def mc_slow(c):
        c.method.mc_fast = False

    def wotn(c):
        c.method.bank_use_bu = False
        c.method.use_weight_rectify = True
        c.method.pseudo_from_initial = True

    layers.set_dropout_impl("pallas")
    try:
        # the disk bank under TransNorm: K3 at the four sites of the S||T
        # forward and their backward; the initial model is not used, no MC
        bank_tn, bank_ms = prototype_path(torch, np, ports, mh, K3, "prototype", {
            "warmup": {"k3_fwd": sites, "k3_bwd": sites},
            "proto": {"k3_fwd": sites, "k3_bwd": sites}}, name="prototype tn", steps=4,
            configure=to_tn, proto_bank=bank, keys=bank_keys | {"loss_bu"})
        # the repeated-batch MC pass: T/2 = 4 no-grad lanes of the model's
        # own dropout sites on top of the S||T forward, no K1
        slow, slow_ms = prototype_path(torch, np, ports, mh, K3, "prototype_full", {
            "warmup": {"k3_fwd": sites, "k3_bwd": sites},
            "proto": {"k3_fwd": sites + 4 * sites, "k3_bwd": sites}},
            name="prototype_full mc_slow", steps=4, configure=mc_slow)
    finally:
        layers.set_dropout_impl("xla16")
    wotn_counts, _ = prototype_path(torch, np, ports, mh, K3, "prototype", {
        "warmup": {}, "proto": {}}, name="prototype woTN", steps=2, warmup=False,
        configure=wotn, proto_bank=bank, keys=bank_keys, banks_move=False)
    say(f"steps in this run (median ms): prototype_full bn {flagship_ms:.2f}, tn {tn_ms:.2f} "
        f"({tn_ms / flagship_ms:.3f}x), mc_slow under 'pallas' {slow_ms:.2f} "
        f"({slow_ms / flagship_ms:.3f}x); prototype tn under 'pallas' {bank_ms:.2f} "
        f"({bank_ms / flagship_ms:.3f}x)")
    other_methods_phase(torch, np, ports, mh, K3)

    # the other backbones and output stride 8: the flagship at full width,
    # K1 once per prototype-phase step whatever the backbone
    backbone_card_phase(torch, np, DeepLab)
    backbone_paths, backbone_ms = [], {}
    for backbone, output_stride in BACKBONE_CASES:
        def on(c, backbone=backbone, output_stride=output_stride):
            c.model.backbone, c.model.output_stride = backbone, output_stride

        launches, backbone_ms[backbone, output_stride] = prototype_path(
            torch, np, ports, mh, K3, "prototype_full", {"warmup": {}, "proto": {"k1": 1}},
            name=f"prototype_full {backbone} OS{output_stride}", steps=BACKBONE_STEPS,
            configure=on)
        backbone_paths.append(launches)
    remat = remat_phase(torch, np, ports, mh, K3)
    bcdm, bcdm_ms = bcdm_phase(torch, np, ports, mh, K3, "xla16")
    bcdm_k3, bcdm_k3_ms = bcdm_phase(torch, np, ports, mh, K3, "pallas")
    say("steps in this run (median ms, x the mobilenet OS16 flagship's "
        f"{flagship_ms:.2f}): " + ", ".join(
            f"{b} OS{o} {ms:.2f} ({ms / flagship_ms:.3f}x)" for (b, o), ms in backbone_ms.items())
        + f"; bcdm {bcdm_ms:.2f} ({bcdm_ms / flagship_ms:.3f}x), under 'pallas' "
        f"{bcdm_k3_ms:.2f} ({bcdm_k3_ms / flagship_ms:.3f}x)")

    wire_phase(torch, np, wire)
    trainer_ports = (cli, ckpt_lib, LOG_HEADERS, Trainer)
    trainer = trainer_phase(torch, trainer_ports, mh, K3, flagship_ms)
    bank_trainer = bank_trainer_phase(torch, np, trainer_ports, cal_prototype, mh, K3)
    bcdm_trainer = bcdm_trainer_phase(torch, trainer_ports, mh, K3)

    # the native host augmentation, the images, the evaluation and export
    # tools, profiling
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        native_phase(np, native, transforms, SyntheticFundus)
        native_trainer, ckpt_dir = native_trainer_phase(torch, trainer_ports, native, mh, K3,
                                                        tmp, flagship_ms)
        ckpt = os.path.join(ckpt_dir, ckpt_lib.latest_checkpoint(ckpt_dir) + ".pth.tar")
        images = images_phase(torch, np, trainer_ports, mh, K3, png, BatchLoader,
                              SyntheticFundus, eval_transforms, tmp)
        eval_phase(torch, np, evaluate, ckpt, tmp)
        export_phase(torch, np, export, evaluate, ckpt, tmp)
        profiled = profiling_phase(torch, np, ports, profiling, mh, K3, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dp, single = dp_phase(torch, np, ports, cli.build_config, LOG_HEADERS, flagship_ms, card)
    spatial = spatial_phase(torch, np, ports, cli.build_config, LOG_HEADERS, card, single)
    # each kernel's launches over every path this run drove
    paths = (benched, tooled, longran, flagship, mt, flagship_tn, bank_tn, slow, wotn_counts,
             *backbone_paths, remat, bcdm, bcdm_k3, trainer, bank_trainer, bcdm_trainer, native_trainer, images,
             profiled, dp, spatial)
    launched = {k: sum(p[k] for p in paths) for k in flagship}
    say(f"launches over the paths: {launched}")

    def row(name, source, replaces, launches, nums, library_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": nums["max_abs_err"], "ms": nums["ms"],
                "plain_ms": nums["plain_ms"], "bound_ms": nums["bound_ms"], "bound_by": "bytes",
                "library_ms": library_ms}

    mask_src, drop_src = "uda_clr_tpu_torch/csrc/mask_head.cu", "uda_clr_tpu_torch/csrc/dropout.cu"
    kernels = [
        # no single PyTorch call computes the mask-head epilogue
        row("mask_head_split", mask_src, "uda_clr_tpu/ops/pallas/mask_head.py:154",
            launched["k1"], mask_numbers["K1"], None),
        # K2 is on no train path (the JAX package calls fused_mask_head only in its tests)
        row("mask_head", mask_src, "uda_clr_tpu/ops/pallas/mask_head.py:65",
            launched["k2"], mask_numbers["K2"], None),
        # K3: times summed over the four dropout sites of one S||T forward
        row("dropout_forward", drop_src, "uda_clr_tpu/ops/pallas/dropout.py:70",
            launched["k3_fwd"], k3_numbers["fwd"], k3_numbers["fwd"]["library_ms"]),
        row("dropout_backward", drop_src, "uda_clr_tpu/ops/pallas/dropout.py:70",
            launched["k3_bwd"], k3_numbers["bwd"], k3_numbers["bwd"]["library_ms"]),
        # K4: its four passes summed over K4_SITES; no Pallas kernel (XLA
        # fused the norm). Its launches are the host's calls: a replayed
        # graph's kernels are in the profiled flagship step's count
        {**row("domain_norm", "uda_clr_tpu_torch/csrc/domain_norm.cu", None,
               {k[3:]: launched[k] for k in K4_KEYS}, k4_numbers, k4_numbers["library_ms"]),
         "max_rel_err": k4_numbers["max_rel_err"],
         "card_kernels_per_flagship_step": flagship_info["k4_card"]},
    ]
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank(json.loads(sys.argv[2]))
    else:
        main()
