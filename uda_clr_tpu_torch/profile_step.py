"""Where a prototype-phase train step's time goes on the card.

    python -m uda_clr_tpu_torch.profile_step [--method prototype_full] [--norm bn]
        [--backbone mobilenet] [--out-stride 16] [--remat] [--mc-slow]
        [--dropout xla16] [--steps 3]

Builds chip_smoke.py's full-width configuration (DeepLabv3+, 512x512, 8
source + 8 target images, T=8, bfloat16) on ``--backbone`` at
``--out-stride`` (drn: always 8), its backbone blocks rematerialised under
``--remat``, for ``--method`` (``prototype_full``, ``prototype_mt``, the
disk-bank ``prototype`` with a random bank, or ``bcdm``, whose steps have
no phases) under ``--norm`` (``bn``, or ``tn`` for TransNorm), with the
repeated-batch MC pass under ``--mc-slow`` (``mc_fast=False``) and the
``--dropout`` backend (``set_dropout_impl``; ``pallas`` runs the fused
dropout kernel); runs one warmup and two prototype-phase steps untimed,
then profiles ``--steps`` prototype-phase steps with ``torch.profiler``.
Prints the device time by operator (top 25), the device time grouped into
families, and the device busy share of the profiled wall time. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from uda_clr_tpu_torch.models import layers
from uda_clr_tpu_torch.train.state import BANK_SIZES, create_train_state
from uda_clr_tpu_torch.train.steps import make_train_step
from uda_clr_tpu_torch.utils.benchmarking import flagship_config

# operator-name fragments -> family, first match wins
FAMILIES = (
    ("mask-head kernel", ("mask_head_kernel",)),
    ("dropout kernel", ("dropout_kernel",)),
    ("convolution", ("conv", "cudnn", "sm90_xmma", "implicit_gemm", "winograd")),
    ("matmul", ("gemm", "mm", "addmm")),
    ("random (dropout draws)", ("uniform", "rand", "philox", "distribution")),
    ("reduction (BN moments, losses)", ("sum", "mean", "reduce", "norm")),
    ("resize", ("upsample", "interpolate")),
    ("copy (casts, layout changes, cat)", ("copy",)),
    ("optimizer", ("adam", "sgd", "foreach", "_fused")),
    ("elementwise", ("elementwise", "vectorized", "mul", "add", "sub", "where", "clamp",
                     "relu", "sigmoid", "log", "exp", "pow", "div", "fill")),
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3, help="profiled prototype-phase steps")
    ap.add_argument("--method", default="prototype_full",
                    choices=("prototype_full", "prototype_mt", "prototype", "bcdm"))
    ap.add_argument("--norm", default="bn", choices=("bn", "tn"))
    ap.add_argument("--backbone", default="mobilenet",
                    choices=("mobilenet", "resnet", "xception", "drn"))
    ap.add_argument("--out-stride", type=int, default=16, choices=(8, 16))
    ap.add_argument("--remat", action="store_true", help="rematerialised backbone blocks")
    ap.add_argument("--mc-slow", action="store_true",
                    help="the repeated-batch MC pass (mc_fast=False)")
    ap.add_argument("--dropout", default="xla16", choices=layers.IMPLS, help="dropout backend")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")

    b, size = 8, 512
    cfg = flagship_config(args.norm)
    cfg.model.backbone = args.backbone
    cfg.model.output_stride = args.out_stride
    cfg.model.remat = args.remat
    cfg.method.mc_fast = not args.mc_slow
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(v.astype(np.float32)).cuda() for k, v in {
        "image_s": rng.standard_normal((b, size, size, 3)),
        "map_s": rng.uniform(0, 1, (b, size, size, 2)) > 0.5,
        "boundary_s": rng.uniform(0, 1, (b, size, size, 1)),
        "image_t": rng.standard_normal((b, size, size, 3)),
    }.items()}
    layers.set_dropout_impl(args.dropout)
    bank = {k: 0.1 * rng.standard_normal(n) for k, n in BANK_SIZES.items()}
    state = create_train_state(cfg, seed=0, device="cuda", method=args.method, proto_bank=bank)
    warm = make_train_step(cfg, args.method, proto_phase=False)
    proto = make_train_step(cfg, args.method, proto_phase=True)
    state, _ = warm(state, batch, 1e-3, 2.5e-5)
    for _ in range(2):
        state, _ = proto(state, batch, 1e-3, 2.5e-5)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, _ = proto(state, batch, 1e-3, 2.5e-5)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # events that ran on the card (kernels, copies, memsets), by name
    kernels: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    device_ms = sum(kernels.values())
    per_step = args.steps
    print(f"{torch.cuda.get_device_name(0)}: {args.method}, {args.backbone} OS "
          f"{state.gen.output_stride}{' remat' if args.remat else ''}, norm {args.norm}, "
          f"mc_fast {cfg.method.mc_fast}, dropout {args.dropout}, "
          f"{per_step} {'' if args.method == 'bcdm' else 'prototype-phase '}steps, "
          f"wall {wall_ms / per_step:.2f} ms/step, device busy {device_ms / per_step:.2f} ms/step "
          f"({100 * device_ms / wall_ms:.1f}% of wall)")
    families: dict[str, float] = {}
    for name, ms in kernels.items():
        low = name.lower()
        fam = next((f for f, keys in FAMILIES if any(k in low for k in keys)), "other")
        families[fam] = families.get(fam, 0.0) + ms
    print("device time by family, from kernel-name keywords (ms/step, share of device time):")
    for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:32s} {ms / per_step:9.3f}  {100 * ms / device_ms:5.1f}%")
    print("top 25 device kernels (ms/step):")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {ms / per_step:9.3f}  {name[:110]}")


if __name__ == "__main__":
    main()
