"""Host input-pipeline throughput at the production shape (the counterpart
of the JAX package's ``tools/bench_pipeline.py``).

    python -m uda_clr_tpu_torch.bench_pipeline [--n 64] [--size 512]
        [--workers 2] [--batch 8] [--device cuda]

``BatchLoader`` images per second through the whole 512x512 train
augmentation (random scale-crop, flip and rotation, the elastic warp,
salt-and-pepper noise, light, the eraser, the boundary ring, normalize;
data/transforms.py) over ``--n`` synthetic fundus images, with the native
augmentation library (``csrc/fundus_aug.cpp``) on and then off
(``data/native.set_enabled``). The first batch of each epoch is untimed
(the workers' start). The card's step consumes 8 images per ~150 ms; the
host must sustain more than that per card to keep it fed. No device work
runs: ``--device`` names the card the host feeds.

Prints one JSON line: a row per setting (img/s, ms per batch), the worker
count, ``host_cores``, ``device_kind`` and ``power_limit_w``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from uda_clr_tpu_torch.utils.devinfo import card_fields


def images_per_second(n: int, size: int, workers: int, batch: int) -> float:
    """One epoch of ``n`` images through the loader: img/s past its first
    batch."""
    from uda_clr_tpu_torch.data.pipeline import BatchLoader
    from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
    from uda_clr_tpu_torch.data.transforms import train_transforms

    ds = SyntheticFundus(n=n, size=size + 32, transform=train_transforms(size))
    it = BatchLoader(ds, batch_size=batch, num_workers=workers, prefetch=2).epoch(0)
    next(it)
    t0 = time.perf_counter()
    count = sum(1 for _ in it)
    if count == 0:
        raise ValueError(f"bench_pipeline: --n {n} holds one batch of {batch}; time needs two")
    return count * batch / (time.perf_counter() - t0)


def main(argv=None) -> dict:
    from uda_clr_tpu_torch import resolve_device
    from uda_clr_tpu_torch.data import native

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64, help="synthetic images")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    before = native.available()
    rows = []
    try:
        for on in (True, False):
            native.set_enabled(on)
            ips = images_per_second(args.n, args.size, args.workers, args.batch)
            rows.append({"native": on, "img_per_sec": round(ips, 2),
                         "ms_per_batch": round(args.batch / ips * 1e3, 2)})
            print(f"# native={on}: {ips:.1f} img/s ({args.workers} workers, "
                  f"{args.size}x{args.size})", file=sys.stderr, flush=True)
    finally:
        native.set_enabled(before)
    result = {
        "metric": f"BatchLoader train augmentation throughput ({args.size}x{args.size}, "
                  f"batch {args.batch}, {args.workers} thread workers)",
        "rows": rows,
        "workers": args.workers,
        "host_cores": os.cpu_count(),
        **card_fields(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
