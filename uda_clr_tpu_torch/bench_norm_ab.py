"""Plain BN against TransNorm on the flagship train step, inside one process
(the counterpart of the JAX package's ``tools/bench_norm_ab.py``).

    python -m uda_clr_tpu_torch.bench_norm_ab [--size 512] [--batch 8]
        [--windows 5] [--iters 10] [--device cuda]

Step times move 150-171 ms between calls of the benchmark (host-bound), so
TransNorm's cost is measured as a ratio inside one process: the
prototype-phase ``prototype_full`` step at ``bench.py``'s configuration
(512x512, 8 + 8 images, T=8, bfloat16, dropout ``UDA_DROPOUT_IMPL``) under
``norm='bn'`` and ``norm='tn'`` (whose MC pass is the standalone fast
forward, K1 once per step). Each configuration gets its first call and 2
warm-up steps, then their windows alternate, bn tn bn tn ...: a drift
through the call (windows that rise as it goes) moves both alike, where
back-to-back runs would charge it to the second.

Prints one JSON line: each norm's median ms, its windows (sorted and in
run order), img/s/card, its first call; ``tn_over_bn`` (the ratio of the
medians); ``proto_steps`` per norm; ``device_kind`` and ``power_limit_w``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from uda_clr_tpu_torch.utils.benchmarking import (
    EPOCH,
    LR_DIS,
    LR_GEN,
    flagship_config,
    staged_train_batch,
    timed_window,
)
from uda_clr_tpu_torch.utils.devinfo import A100_REFERENCE_IMG_PER_SEC, card_fields

NORMS = ("bn", "tn")
WARMUP = 2  # untimed steps after the first call


def main(argv=None) -> dict:
    from uda_clr_tpu_torch import resolve_device
    from uda_clr_tpu_torch.models.layers import set_dropout_impl
    from uda_clr_tpu_torch.train.state import create_train_state
    from uda_clr_tpu_torch.train.steps import make_train_step

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8, help="images per domain")
    ap.add_argument("--windows", type=int, default=5, help="timed windows per norm")
    ap.add_argument("--iters", type=int, default=10, help="steps per window")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    set_dropout_impl(os.environ.get("UDA_DROPOUT_IMPL", "xla16"))
    data = staged_train_batch(args.batch, args.size, device)
    runs = {}
    for norm in NORMS:
        cfg = flagship_config(norm)
        step = make_train_step(cfg, "prototype_full", proto_phase=True)

        def step_once(st, step=step):
            st, metrics = step(st, data, LR_GEN, LR_DIS, EPOCH)
            return st, metrics["loss_all"]

        state = create_train_state(cfg, seed=0, device=device)
        state, first_ms = timed_window(step_once, state, 1)
        state, _ = timed_window(step_once, state, WARMUP)
        runs[norm] = {"step_once": step_once, "state": state, "windows": [],
                      "first_call_s": first_ms / 1e3}
    for _ in range(args.windows):
        for norm in NORMS:
            run = runs[norm]
            run["state"], ms = timed_window(run["step_once"], run["state"], args.iters)
            run["windows"].append(ms)

    out = {}
    for norm in NORMS:
        windows = runs[norm]["windows"]
        med = float(np.median(windows))
        out[norm] = {
            "step_ms_median": round(med, 2),
            "step_ms_windows": [round(w, 2) for w in sorted(windows)],
            "step_ms_windows_run_order": [round(w, 2) for w in windows],
            "img_per_sec_card": round(args.batch / (med / 1e3), 2),
            "first_call_s": round(runs[norm]["first_call_s"], 2),
        }
        print(f"# [{norm}] {med:.2f} ms/step, windows in run order "
              f"{out[norm]['step_ms_windows_run_order']}", file=sys.stderr, flush=True)
    ratio = out["tn"]["step_ms_median"] / out["bn"]["step_ms_median"]
    result = {
        "metric": f"prototype_full bn vs tn in one process ({args.size}x{args.size}, "
                  f"B{args.batch}, T=8 MC, bf16; windows alternate)",
        **out,
        "tn_over_bn": round(ratio, 4),
        "tn_vs_baseline": round(out["tn"]["img_per_sec_card"] / A100_REFERENCE_IMG_PER_SEC, 3),
        # per norm: the first call, the warm-up steps and the windows
        "proto_steps": {norm: 1 + WARMUP + args.windows * args.iters for norm in NORMS},
        **card_fields(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
