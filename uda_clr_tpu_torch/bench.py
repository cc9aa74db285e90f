"""Train-throughput benchmark of the port on one card (the counterpart of the
JAX package's ``bench.py``).

    python -m uda_clr_tpu_torch.bench [--device cuda] [--windows 5] [--iters 10]
        [--host-fed-steps 12]

Times the flagship step at the reference's production configuration: the
prototype-phase ``prototype_full`` step (the S||T forward, the T=8 MC
rectification through the mask-head kernel K1, the prototype EMA banks,
the adversarial G update and both discriminators' updates) on mobilenet
DeepLabv3+ at output stride 16, 512x512, 8 source + 8 target images,
bfloat16, the default dropout backend ``'xla16'``. One first call (the
kernels' build and cuDNN's algorithm search), 2 warm-up steps, then
``--windows`` windows of ``--iters`` chained steps on a batch staged on the
card; the median window is the headline. One more step runs untimed under
FlopCounterMode for ``mfu`` (utils/benchmarking.py says what it counts;
it is not the JAX package's ``mfu``).

Then two host-fed rows, as the JAX benchmark runs them: the real loader
(the whole train augmentation) feeding the same step, uint8 wire with
forked-process workers, then float32 with threads, ``min(2, cores)``
workers each. Each row gives its ms per step, ``device_fraction`` (the
staged step's median over the host-fed step), ``h2d_ms`` (one batch's
copy to the card, measured before any worker exists) and ``load_ms`` (the
loaders alone). A row that fails ends the run with its error.

One process drives one card: the port's data parallelism is one process
per card, so the value is images per second per card.

Knobs (environment, as the JAX benchmark's): ``UDA_BENCH_METHOD``
(default ``prototype_full``), ``UDA_BENCH_NORM`` (``bn``; ``tn`` for
TransNorm), ``UDA_BENCH_WIRE`` (``f32``; ``u8`` stages the timed batch in
the uint8 wire format), ``UDA_BENCH_SIZE`` (512) and ``UDA_BENCH_BATCH``
(8), ``UDA_DROPOUT_IMPL`` (``xla16``; ``pallas`` runs the dropout kernel
K3) and ``UDA_MASKHEAD_IMPL`` (``auto``: K1; ``xla``: its plain version).
``--device cpu`` runs the kernels' plain versions on the CPU, for tests;
without a card and without it, the benchmark raises.

The last line of standard output is one JSON object with the JAX
benchmark's keys: ``metric``, ``value`` (images/sec/card), ``unit``,
``vs_baseline`` (value / the reference's estimated 20 img/s on an A100),
``vs_baseline_range`` (value / 25 and / 15), ``step_ms_median``,
``step_ms_windows``, ``mfu``, ``step_tflops``, ``host_fed`` (u8 rows),
``host_fed_f32``, ``device_kind`` (the card's name), and
``power_limit_w`` (nvidia-smi's power limit; None on the CPU).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

from uda_clr_tpu_torch.utils.benchmarking import (
    EPOCH,
    LR_DIS,
    LR_GEN,
    count_flops,
    flagship_config,
    mfu,
    staged_train_batch,
    timed_windows,
)
from uda_clr_tpu_torch.utils.devinfo import A100_REFERENCE_IMG_PER_SEC, card_fields


def host_fed_row(step, state, device, size: int, batch: int, wire: str, backend: str,
                 workers: int, steps: int, median_ms: float):
    """One host-fed row: the loader feeding ``step`` in the ``wire`` format
    with ``backend`` workers. Returns (row, state)."""
    from uda_clr_tpu_torch.data.pipeline import collate
    from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
    from uda_clr_tpu_torch.data.transforms import train_transforms
    from uda_clr_tpu_torch.utils import hostfeed

    ds_s = SyntheticFundus(n=16, size=size + 32, transform=train_transforms(size, wire=wire))
    ds_t = SyntheticFundus(n=16, size=size + 32, transform=train_transforms(size, wire=wire),
                           seed=1)
    # one real loader batch in this wire format (the staged batch is noise,
    # not encodable as u8), copied before any loader worker exists
    bs0 = collate([ds_s.get(i, np.random.default_rng((0, i))) for i in range(batch)])
    bt0 = collate([ds_t.get(i, np.random.default_rng((1, i))) for i in range(batch)])
    one = {"image_s": bs0["image"], "map_s": bs0["map"], "boundary_s": bs0["boundary"],
           "image_t": bt0["image"]}
    h2d_ms, nbytes = hostfeed.h2d_probe(one, device)

    gen = hostfeed.paired_batches(ds_s, ds_t, batch, workers, backend=backend)
    try:
        hf_ms, state = hostfeed.host_fed_window(step, state, gen, device, steps,
                                                LR_GEN, LR_DIS, EPOCH)
        load_ms = hostfeed.pure_load_ms(gen, steps, workers=workers)
    finally:
        gen.close()
    row = {
        "step_ms": round(hf_ms, 1),
        "img_per_sec_card": round(batch / (hf_ms / 1e3), 2),
        "wire": wire,
        "backend": backend,
        "workers": workers,
        "host_cores": os.cpu_count(),
        "device_fraction": round(median_ms / hf_ms, 3),
        "h2d_ms": round(h2d_ms, 1),
        "h2d_mbytes": round(nbytes / 1e6, 1),
        "load_ms": round(load_ms, 1),
    }
    print(f"# host-fed ({wire}/{backend} x{workers}): {hf_ms:.1f} ms/step",
          file=sys.stderr, flush=True)
    return row, state


def main(argv=None) -> dict:
    from uda_clr_tpu_torch import resolve_device
    from uda_clr_tpu_torch.models.layers import set_dropout_impl
    from uda_clr_tpu_torch.train.state import create_train_state
    from uda_clr_tpu_torch.train.steps import make_train_step

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--windows", type=int, default=5, help="timed windows")
    ap.add_argument("--iters", type=int, default=10, help="steps per window")
    ap.add_argument("--host-fed-steps", type=int, default=12, help="timed steps per host-fed row")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    set_dropout_impl(os.environ.get("UDA_DROPOUT_IMPL", "xla16"))
    norm = os.environ.get("UDA_BENCH_NORM", "bn")
    method = os.environ.get("UDA_BENCH_METHOD", "prototype_full")
    wire = os.environ.get("UDA_BENCH_WIRE", "f32")
    # the production shape unless a test shrinks it
    size = int(os.environ.get("UDA_BENCH_SIZE", "512"))
    batch = int(os.environ.get("UDA_BENCH_BATCH", "8"))
    cfg = flagship_config(norm, method)
    cfg.method.mask_head_impl = os.environ.get("UDA_MASKHEAD_IMPL", "auto")

    state = create_train_state(cfg, seed=0, device=device, method=method)
    data = staged_train_batch(batch, size, device, wire=wire)
    step = make_train_step(cfg, method, proto_phase=True)

    def step_once(st):
        st, metrics = step(st, data, LR_GEN, LR_DIS, EPOCH)
        return st, metrics["loss_all"]

    print("# first call, warm-up, timed windows...", file=sys.stderr, flush=True)
    state, stats = timed_windows(step_once, state, windows=args.windows, iters=args.iters)
    window_ms, med_ms = stats["window_ms"], stats["median_ms"]
    card = card_fields(device)
    kind = card["device_kind"]
    (state, metrics), flops = count_flops(lambda: step(state, data, LR_GEN, LR_DIS, EPOCH))
    loss = float(metrics["loss_all"])
    if not math.isfinite(loss):
        raise FloatingPointError(f"bench: the step's loss_all is {loss}")
    step_mfu, step_tflops = mfu(flops, med_ms, kind)

    workers = min(2, os.cpu_count() or 1)
    host_fed, state = host_fed_row(step, state, device, size, batch, "u8", "process", workers,
                                   args.host_fed_steps, med_ms)
    host_fed_f32, state = host_fed_row(step, state, device, size, batch, "f32", "thread",
                                       workers, args.host_fed_steps, med_ms)

    ips = batch / (med_ms / 1e3)
    result = {
        "metric": f"{method} train throughput ({size}x{size}, B{batch}, T=8 MC, bf16"
        + (", TransNorm" if norm == "tn" else "")
        + (", u8 wire)" if wire == "u8" else ")"),
        "value": round(ips, 2),
        "unit": "images/sec/card",
        "vs_baseline": round(ips / A100_REFERENCE_IMG_PER_SEC, 3),
        # the denominator is an estimate: plausible A100 numbers of 15-25
        # img/s bound the ratio
        "vs_baseline_range": [round(ips / 25.0, 2), round(ips / 15.0, 2)],
        "step_ms_median": round(med_ms, 2),
        "step_ms_windows": [round(w, 2) for w in window_ms],
        "mfu": round(step_mfu, 4) if step_mfu is not None else None,
        "step_tflops": round(step_tflops, 6),
        "host_fed": host_fed,
        "host_fed_f32": host_fed_f32,
        **card,
        "first_call_s": round(stats["first_call_s"], 2),
    }
    in_order = ", ".join(f"{w:.2f}" for w in stats["window_ms_run_order"])
    print(f"# {kind}: first call {stats['first_call_s']:.1f} s, step {med_ms:.2f} ms "
          f"(windows in run order {in_order}), {step_tflops:.3f} TFLOP/step, "
          f"loss {loss:.4f}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
