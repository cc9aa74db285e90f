"""The host-fed train step against the worker count, on one card (the
counterpart of the JAX package's ``tools/bench_e2e.py``).

    python -m uda_clr_tpu_torch.bench_e2e [--size 512] [--batch 8] [--steps 24]
        [--workers 1,2,<cores>] [--backend thread|process] [--norm bn]
        [--n-data 64] [--device cuda]

``bench.py`` times the step on a batch staged on the card, and its two
host-fed rows at ``min(2, cores)`` workers. This measures how the host
feed scales: the port's ``BatchLoader`` (the whole 512x512 train
augmentation over synthetic fundus images, source and target loaders)
feeding ``bench.py``'s step as the Trainer feeds it (utils/hostfeed.py:
each batch pair copied to the card from pinned memory, the next loading
while the card runs the step), in the same call:

* a staged window: ``--steps`` steps on one real loader batch on the card
  (after a first call and 2 warm-up steps);
* ``h2d_ms``: one batch pair's copy to the card, before any worker starts;
* one host-fed window of ``--steps`` steps per worker count, thread or
  forked-process workers (``--backend``), each with its
  ``device_fraction`` (the staged step over the host-fed step) and
  ``load_ms`` (the loaders alone, no device work).

Prints one JSON line: the staged step, the copy, a row per worker count,
``host_cores``, ``proto_steps``, ``device_kind`` and ``power_limit_w``.
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
    timed_windows,
)
from uda_clr_tpu_torch.utils.devinfo import card_fields


def main(argv=None) -> dict:
    from uda_clr_tpu_torch import resolve_device
    from uda_clr_tpu_torch.data.pipeline import collate
    from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
    from uda_clr_tpu_torch.data.transforms import train_transforms
    from uda_clr_tpu_torch.models.layers import set_dropout_impl
    from uda_clr_tpu_torch.train.state import create_train_state
    from uda_clr_tpu_torch.train.steps import make_train_step
    from uda_clr_tpu_torch.utils import hostfeed

    cores = os.cpu_count() or 1
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8, help="images per domain")
    ap.add_argument("--steps", type=int, default=24, help="steps per timed window")
    ap.add_argument("--workers", default=f"1,2,{cores}", help="comma list of worker counts")
    ap.add_argument("--backend", default="thread", choices=("thread", "process"))
    ap.add_argument("--norm", default="bn", choices=("bn", "tn"))
    ap.add_argument("--n-data", type=int, default=64, help="synthetic images per domain")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    size, batch = args.size, args.batch

    set_dropout_impl(os.environ.get("UDA_DROPOUT_IMPL", "xla16"))
    cfg = flagship_config(args.norm)
    state = create_train_state(cfg, seed=0, device=device)
    step = make_train_step(cfg, "prototype_full", proto_phase=True)
    ds_s = SyntheticFundus(n=args.n_data, size=size + 32, transform=train_transforms(size))
    ds_t = SyntheticFundus(n=args.n_data, size=size + 32, transform=train_transforms(size),
                           seed=1)

    # one real batch pair, made here before any loader worker exists
    bs = collate([ds_s.get(i, np.random.default_rng((0, i))) for i in range(batch)])
    bt = collate([ds_t.get(i, np.random.default_rng((1, i))) for i in range(batch)])
    staged = hostfeed.device_batch(bs, bt, device)

    def step_once(st):
        st, metrics = step(st, staged, LR_GEN, LR_DIS, EPOCH)
        return st, metrics["loss_all"]

    state, stats = timed_windows(step_once, state, windows=1, iters=args.steps)
    staged_ms = stats["median_ms"]
    print(f"# staged: {staged_ms:.2f} ms/step (first call {stats['first_call_s']:.1f} s)",
          file=sys.stderr, flush=True)
    one = {"image_s": bs["image"], "map_s": bs["map"], "boundary_s": bs["boundary"],
           "image_t": bt["image"]}
    h2d_ms, nbytes = hostfeed.h2d_probe(one, device)

    rows = []
    for workers in [int(w) for w in args.workers.split(",")]:
        gen = hostfeed.paired_batches(ds_s, ds_t, batch, workers, backend=args.backend)
        try:
            ms, state = hostfeed.host_fed_window(step, state, gen, device, args.steps,
                                                 LR_GEN, LR_DIS, EPOCH)
            load_ms = hostfeed.pure_load_ms(gen, args.steps, workers=workers)
        finally:
            gen.close()  # this row's workers stop before the next row's start
        rows.append({"workers": workers, "backend": args.backend, "step_ms": round(ms, 2),
                     "img_per_sec_card": round(batch / (ms / 1e3), 2),
                     "device_fraction": round(staged_ms / ms, 3),
                     "load_ms": round(load_ms, 2)})
        print(f"# host-fed ({args.backend} x{workers}): {ms:.1f} ms/step, load "
              f"{load_ms:.1f} ms", file=sys.stderr, flush=True)

    result = {
        "metric": f"host-fed train throughput against workers ({size}x{size}, B{batch}, "
                  f"T=8 MC, bf16, {args.norm}, {args.backend} workers)",
        "staged_step_ms": round(staged_ms, 2),
        "staged_img_per_sec_card": round(batch / (staged_ms / 1e3), 2),
        "h2d_ms": round(h2d_ms, 2),
        "h2d_mbytes": round(nbytes / 1e6, 1),
        "host_fed": rows,
        "host_cores": cores,
        # the staged window's first call, warm-up and steps; per row its
        # untimed step and its steps
        "proto_steps": 3 + args.steps + len(rows) * (1 + args.steps),
        **card_fields(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
