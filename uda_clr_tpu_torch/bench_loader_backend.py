"""Thread against process loader workers, with the host CPU per batch and
the share of it that holds the interpreter lock (the counterpart of the
JAX package's ``tools/bench_loader_backend.py``).

    python -m uda_clr_tpu_torch.bench_loader_backend [--batches 12] [--size 512]
        [--batch 8] [--workers 1,2] [--out runs/loader_backend_ab.csv] [--device cuda]

The reference feeds its card from 6 worker processes. The port's
``BatchLoader`` runs thread or forked-process workers (data/pipeline.py);
which scales depends on how much of a batch's CPU holds the lock. Each
cell (backend x workers) drains the same ``DRAIN`` batches first, so all
cells time the same batch indices (the augmentation's cost depends on the
sample's seed), then times ``--batches`` batches of the u8-wire train
augmentation at ``--size``:

* ``ms_per_batch``: wall per batch;
* ``cpu_s_per_batch`` (threads): the process's CPU per batch, the
  augmentation and collation whole: the numerator of "cores per card";
* ``parent_cpu_s_per_batch`` (processes): the parent's own CPU per batch
  (unpickling, collation, the queue), the serial term that caps the
  process backend at 1 / it batches per second however many workers run.

Then ``gil_stall_frac``, by the gap probe of the JAX tool: one thread
worker runs while a probe thread loops on the clock; a gap of more than 4
switch intervals between its iterations can only be a call that held the
lock without yielding (bytecode yields every switch interval). Their sum
per batch, over the cell's ``cpu_s_per_batch``, is the share of a batch
that thread workers can never overlap.

Writes the cells to ``--out`` (CSV) and prints one JSON line: the cells,
the probe's numbers, ``gil_stall_frac``, the ceilings they imply
(batches/s), ``host_cores``, ``device_kind`` (the card the host feeds; no
device work runs) and ``power_limit_w``.
"""

from __future__ import annotations

import argparse
import csv
import itertools
import json
import os
import sys
import threading
import time

from uda_clr_tpu_torch.utils.devinfo import card_fields

# every cell drains as many batches before its timed ones, so all cells
# time the same batch indices
DRAIN = 5


def forever(ds, batch: int, backend: str, workers: int, prefetch: int = 2):
    """Batches of ``ds`` epoch after epoch, the first ``DRAIN`` pulled."""
    from uda_clr_tpu_torch.data.pipeline import BatchLoader

    loader = BatchLoader(ds, batch_size=batch, shuffle=True, seed=0, num_workers=workers,
                         prefetch=prefetch, backend=backend)

    def gen():
        for ep in itertools.count():
            yield from loader.epoch(ep)

    g = gen()
    for _ in range(DRAIN):
        next(g)
    return g


def measure_cell(ds, batch: int, backend: str, workers: int, batches: int) -> dict:
    """Wall and this process's CPU per batch, past the drain."""
    gen = forever(ds, batch, backend, workers)
    try:
        cpu0, t0 = time.process_time(), time.perf_counter()
        for _ in range(batches):
            next(gen)
        wall, cpu = time.perf_counter() - t0, time.process_time() - cpu0
    finally:
        gen.close()
    cell = {"backend": backend, "workers": workers,
            "ms_per_batch": round(wall / batches * 1e3, 2)}
    key = "cpu_s_per_batch" if backend == "thread" else "parent_cpu_s_per_batch"
    cell[key] = round(cpu / batches, 4)
    return cell


def measure_gil_stalls(ds, batch: int, batches: int) -> dict:
    """Seconds per batch the lock was held without yielding: the probe
    thread's gaps above 4 switch intervals, one thread worker running."""
    switch = sys.getswitchinterval()
    threshold = 4.0 * switch
    stalls = []
    stop = threading.Event()

    def probe():
        last = time.monotonic()
        while not stop.is_set():
            now = time.monotonic()
            if now - last > threshold:
                stalls.append(now - last)
            last = now

    gen = forever(ds, batch, "thread", 1)
    thread = threading.Thread(target=probe, daemon=True)
    thread.start()
    try:
        for _ in range(batches):
            next(gen)
    finally:
        stop.set()
        thread.join(timeout=10.0)
        gen.close()
    return {
        "gil_held_s_per_batch": round(sum(stalls) / batches, 4),
        "gil_stall_count": len(stalls),
        "gil_stall_max_ms": round(max(stalls) * 1e3, 2) if stalls else 0.0,
        "switch_interval_ms": round(switch * 1e3, 3),
    }


def main(argv=None) -> dict:
    from uda_clr_tpu_torch import resolve_device
    from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
    from uda_clr_tpu_torch.data.transforms import train_transforms

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=12, help="timed batches per cell")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workers", default="1,2", help="comma list of worker counts")
    ap.add_argument("--out", default=os.path.join("runs", "loader_backend_ab.csv"))
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ds = SyntheticFundus(n=16, size=args.size + 32,
                         transform=train_transforms(args.size, wire="u8"))
    workers = [int(w) for w in args.workers.split(",")]
    cells = []
    for backend in ("thread", "process"):
        for w in workers:
            cells.append(measure_cell(ds, args.batch, backend, w, args.batches))
            print(f"# {cells[-1]}", file=sys.stderr, flush=True)
    gil = measure_gil_stalls(ds, args.batch, args.batches)
    print(f"# {gil}", file=sys.stderr, flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", newline="") as f:
        fields = sorted({k for c in cells for k in c}, key=lambda k: k != "backend")
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        writer.writerows(cells)

    thread1 = next(c for c in cells if c["backend"] == "thread" and c["workers"] == workers[0])
    proc1 = next(c for c in cells if c["backend"] == "process" and c["workers"] == workers[0])
    frac = min(1.0, gil["gil_held_s_per_batch"] / max(thread1["cpu_s_per_batch"], 1e-6))
    result = {
        "metric": f"loader backends ({args.size}x{args.size}, batch {args.batch}, u8 wire)",
        "host_cores": os.cpu_count(),
        "cells": cells,
        **gil,
        "gil_stall_frac": round(frac, 4),
        # the batches/s the measurements allow with many cores: threads by
        # the unyielding lock holds (null when none was seen: bytecode that
        # holds the lock and yields is not bounded by the probe), processes
        # by the parent's serial CPU
        "thread_ceiling_batch_s": (round(1.0 / gil["gil_held_s_per_batch"], 2)
                                   if gil["gil_held_s_per_batch"] > 1e-3 else None),
        "process_ceiling_batch_s": round(1.0 / max(proc1["parent_cpu_s_per_batch"], 1e-6), 2),
        "csv": args.out,
        **card_fields(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
