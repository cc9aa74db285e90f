"""Throughput of the flagship train step against the batch size on one card
(the counterpart of the JAX package's ``tools/bench_batch_scaling.py``).

    python -m uda_clr_tpu_torch.bench_batch_scaling [--batches 8,16,32]
        [--size 512] [--windows 3] [--iters 10] [--remat] [--device cuda]

The reference trains at 8 source + 8 target images; under data
parallelism the batch per card is a free knob. This times ``bench.py``'s
step (prototype-phase ``prototype_full``, T=8, bfloat16, dropout
``UDA_DROPOUT_IMPL``) at each batch (images per domain) on a random batch
staged on the card: a first call, 2 warm-up steps, ``--windows`` windows
of ``--iters`` steps (utils/benchmarking.timed_windows), and one more step
under FlopCounterMode for ``mfu``. ``--remat`` rematerialises the
backbone's blocks (``cfg.model.remat``), which frees memory for larger
batches at the cost of a second backbone forward.

A batch above 8 that runs out of device memory gives a row with ``error``,
as in the JAX tool; batch 8, the reference's, must run, and any other
error raises. Prints one JSON line: a row per batch (median ms, windows,
img/s/card, ``mfu``, ``step_tflops``, peak GiB from
``torch.cuda.max_memory_allocated``, first call), ``proto_steps``,
``device_kind`` and ``power_limit_w``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from uda_clr_tpu_torch.utils.benchmarking import (
    EPOCH,
    LR_DIS,
    LR_GEN,
    count_flops,
    flagship_config,
    mfu,
    oom_message,
    staged_train_batch,
    timed_windows,
)
from uda_clr_tpu_torch.utils.devinfo import card_fields

REFERENCE_BATCH = 8


def measure(cfg, batch: int, size: int, windows: int, iters: int, device, kind: str) -> dict:
    """One row: the step at ``batch`` images per domain."""
    from uda_clr_tpu_torch.train.state import create_train_state
    from uda_clr_tpu_torch.train.steps import make_train_step

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = create_train_state(cfg, seed=0, device=device)
    data = staged_train_batch(batch, size, device)
    step = make_train_step(cfg, "prototype_full", proto_phase=True)

    def step_once(st):
        st, metrics = step(st, data, LR_GEN, LR_DIS, EPOCH)
        return st, metrics["loss_all"]

    state, stats = timed_windows(step_once, state, windows=windows, iters=iters)
    med = stats["median_ms"]
    (state, _), flops = count_flops(lambda: step(state, data, LR_GEN, LR_DIS, EPOCH))
    step_mfu, tflops = mfu(flops, med, kind)
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    row = {"batch": batch, "step_ms": round(med, 2),
           "step_ms_windows": [round(w, 2) for w in stats["window_ms"]],
           "img_per_sec_card": round(batch / (med / 1e3), 2),
           "mfu": round(step_mfu, 4) if step_mfu is not None else None,
           "step_tflops": round(tflops, 6),
           "peak_gib": round(peak, 2) if peak is not None else None,
           "first_call_s": round(stats["first_call_s"], 2),
           "proto_steps": 3 + windows * iters + 1}
    print(f"# B{batch}: {med:.2f} ms/step, {row['img_per_sec_card']} img/s, mfu {row['mfu']}, "
          f"peak {row['peak_gib']} GiB", file=sys.stderr, flush=True)
    return row


def main(argv=None) -> dict:
    from uda_clr_tpu_torch import resolve_device
    from uda_clr_tpu_torch.models.layers import set_dropout_impl

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="8,16,32", help="images per domain")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--remat", action="store_true", help="rematerialised backbone blocks")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    set_dropout_impl(os.environ.get("UDA_DROPOUT_IMPL", "xla16"))
    cfg = flagship_config("bn")
    cfg.model.remat = args.remat
    card = card_fields(device)
    rows = []
    for batch in [int(b) for b in args.batches.split(",")]:
        try:
            rows.append(measure(cfg, batch, args.size, args.windows, args.iters, device,
                                card["device_kind"]))
        except torch.cuda.OutOfMemoryError as e:
            if batch <= REFERENCE_BATCH:
                raise
            rows.append({"batch": batch, "error": oom_message(e)})
            print(f"# B{batch}: {rows[-1]['error']}", file=sys.stderr, flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    result = {
        "metric": f"prototype_full batch scaling ({args.size}x{args.size}, T=8 MC, bf16"
                  + (", remat)" if args.remat else ")"),
        "rows": rows,
        "proto_steps": sum(r.get("proto_steps", 0) for r in rows),
        **card,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
