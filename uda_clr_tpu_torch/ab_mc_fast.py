"""The fast MC rectification against the slow one over a short training run
(the counterpart of the JAX package's ``tools/ab_mc_fast.py``).

    python -m uda_clr_tpu_torch.ab_mc_fast [--steps 60] [--size 256] [--batch 8]
        [--out runs/ab_mc_fast.csv] [--device cuda]

Three variants of the prototype-phase ``prototype_full`` step (T=8,
bfloat16, mobilenet OS16, ``norm='bn'``), each from the same seed on the
same stream of random numpy batches:

* ``fast_fused``: ``mc_fast``, the MC mask head through the kernel K1
  (``mask_head_impl='auto'``, the default);
* ``fast_plain``: ``mc_fast``, K1's plain version (``mask_head_impl='xla'``,
  the knob ``bench.py`` reads as ``UDA_MASKHEAD_IMPL``): isolates the kernel;
* ``slow``: ``mc_fast=False``, the reference's repeated-batch MC forwards.

The variants differ only inside the no-grad MC sampling (the norms'
statistics over the T samples, and the dropout draws), so their loss
trajectories should agree in distribution; a systematic gap would mean
the fast path is not noise.

Writes a CSV of each step's ``loss_all``, ``loss_intra`` and ``std_mass``
(the mean of the first target image's MC std map) per variant, and prints
one JSON line: per variant the means of the last 10 steps, the first and
last ``loss_all``, whether every value was finite and its K1 launches;
``device_kind`` and ``power_limit_w``.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import sys

import numpy as np
import torch

from uda_clr_tpu_torch.utils.benchmarking import EPOCH, LR_DIS, LR_GEN, flagship_config
from uda_clr_tpu_torch.utils.devinfo import card_fields

VARIANTS = (("fast_fused", True, "auto"), ("fast_plain", True, "xla"), ("slow", False, "xla"))
SERIES = ("loss_all", "loss_intra", "std_mass")
LAST = 10


def batches(steps: int, batch: int, size: int, device):
    """The variants' shared stream: ``steps`` random batches from seed 0."""
    rng = np.random.default_rng(0)
    shape = (batch, size, size)
    for _ in range(steps):
        arrs = {
            "image_s": rng.standard_normal(shape + (3,)).astype(np.float32),
            "map_s": (rng.uniform(0, 1, shape + (2,)) > 0.5).astype(np.float32),
            "boundary_s": rng.uniform(0, 1, shape + (1,)).astype(np.float32),
            "image_t": rng.standard_normal(shape + (3,)).astype(np.float32),
        }
        yield {k: torch.from_numpy(v).to(device) for k, v in arrs.items()}


def run_variant(mc_fast: bool, mask_head_impl: str, steps: int, batch: int, size: int,
                device) -> dict:
    """{series: per-step values} of one variant."""
    from uda_clr_tpu_torch.ops import mask_head
    from uda_clr_tpu_torch.train.state import create_train_state
    from uda_clr_tpu_torch.train.steps import make_train_step

    cfg = flagship_config("bn")
    cfg.method.mc_fast = mc_fast
    cfg.method.mask_head_impl = mask_head_impl
    state = create_train_state(cfg, seed=0, device=device)
    step = make_train_step(cfg, "prototype_full", proto_phase=True)
    out = {k: [] for k in SERIES}
    k1 = mask_head.LAUNCHES
    for data in batches(steps, batch, size, device):
        state, m = step(state, data, LR_GEN, LR_DIS, EPOCH)
        out["loss_all"].append(float(m["loss_all"]))
        out["loss_intra"].append(float(m["loss_intra"]))
        out["std_mass"].append(float(m["_viz"]["std_t"].mean()))
    out["k1_launches"] = mask_head.LAUNCHES - k1
    return out


def main(argv=None) -> dict:
    from uda_clr_tpu_torch import resolve_device
    from uda_clr_tpu_torch.models.layers import set_dropout_impl

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8, help="images per domain")
    ap.add_argument("--out", default=os.path.join("runs", "ab_mc_fast.csv"))
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    set_dropout_impl(os.environ.get("UDA_DROPOUT_IMPL", "xla16"))
    runs = {name: run_variant(fast, impl, args.steps, args.batch, args.size, device)
            for name, fast, impl in VARIANTS}

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["step"] + [f"{n}_{k}" for n, _, _ in VARIANTS for k in SERIES])
        for i in range(args.steps):
            writer.writerow([i] + [runs[n][k][i] for n, _, _ in VARIANTS for k in SERIES])

    variants = {}
    for name, _, _ in VARIANTS:
        r = runs[name]
        variants[name] = {
            **{f"{k}_last{LAST}": float(np.mean(r[k][-LAST:])) for k in SERIES},
            "loss_all_first": r["loss_all"][0],
            "loss_all_last": r["loss_all"][-1],
            "finite": all(math.isfinite(v) for k in SERIES for v in r[k]),
            "k1_launches": r["k1_launches"],
        }
        print(f"# {name}: loss_all {r['loss_all'][0]:.4f} -> {r['loss_all'][-1]:.4f}, last "
              f"{LAST}: loss_all {variants[name][f'loss_all_last{LAST}']:.4f}, loss_intra "
              f"{variants[name][f'loss_intra_last{LAST}']:.5f}, std_mass "
              f"{variants[name][f'std_mass_last{LAST}']:.5f}", file=sys.stderr, flush=True)
    result = {
        "metric": f"prototype_full fast vs slow MC over {args.steps} steps ({args.size}x"
                  f"{args.size}, B{args.batch}, T=8 MC, bf16)",
        "steps": args.steps,
        "variants": variants,
        "csv": args.out,
        **card_fields(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
