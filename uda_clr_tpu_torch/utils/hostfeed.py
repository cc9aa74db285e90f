"""Host-fed throughput helpers (the counterpart of
uda_clr_tpu/utils/hostfeed.py): one implementation of the host -> device
feeding that ``bench.py``'s ``host_fed`` rows measure.

The pattern measured is the Trainer's: the port's ``BatchLoader`` (the
whole train augmentation, thread or forked-process workers) -> each array
of a batch pair copied to the card from pinned memory
(``parallel/distributed.put_global``) -> the train step, the next batch
loading while the card runs the step.

Every clock stops on ``float()`` of a scalar that depends on the timed
work; on a CUDA tensor that waits for the card.
"""

from __future__ import annotations

import time
from typing import Iterator

import torch

from uda_clr_tpu_torch.parallel.distributed import put_global


def h2d_probe(host_batch: dict, device, loads: int = 6) -> tuple[float, int]:
    """Pure host -> device cost of one step's batch: mean ms to copy every
    array of ``host_batch`` to ``device`` (pinned, non-blocking, as the
    Trainer copies), and the batch's bytes.

    Measure this before any loader worker exists: workers competing for the
    host's cores inflate it."""
    device = torch.device(device)
    nbytes = sum(v.nbytes for v in host_batch.values())

    def load_once():
        d = {k: put_global(v, device) for k, v in host_batch.items()}
        # a barrier that depends on every copied array
        float(sum(v.reshape(-1)[0].float() for v in d.values()))

    load_once()  # the first pinning and the first kernels run untimed
    t0 = time.perf_counter()
    for _ in range(loads):
        load_once()
    return (time.perf_counter() - t0) / loads * 1000.0, nbytes


def paired_batches(ds_s, ds_t, batch: int, workers: int, prefetch: int = 2,
                   epochs: int = 10**6, backend: str = "thread") -> Iterator[tuple]:
    """(source, target) host batches from two fresh loaders, epoch after
    epoch: the Trainer's feeding pattern. Each ``epoch()`` starts its own
    workers, so an abandoned generator is safe to close. ``backend``:
    thread or forked-process workers (data/pipeline.py)."""
    from uda_clr_tpu_torch.data.pipeline import BatchLoader

    loader_s = BatchLoader(ds_s, batch_size=batch, num_workers=workers, prefetch=prefetch,
                           backend=backend)
    loader_t = BatchLoader(ds_t, batch_size=batch, num_workers=workers, prefetch=prefetch,
                           backend=backend)
    if len(loader_s) == 0 or len(loader_t) == 0:
        raise ValueError(
            f"paired_batches: a dataset yields zero batches per epoch "
            f"(len={len(ds_s)}/{len(ds_t)} < batch_size={batch}): the stream would spin "
            f"through empty epochs and end with no diagnostic")
    for ep in range(epochs):
        for bs, bt in zip(loader_s.epoch(ep), loader_t.epoch(ep + 1000)):
            yield bs, bt


def device_batch(bs: dict, bt: dict, device) -> dict:
    """One (source, target) host batch pair as the train step's input, each
    array on ``device``."""
    device = torch.device(device)
    return {
        "image_s": put_global(bs["image"], device),
        "map_s": put_global(bs["map"], device),
        "boundary_s": put_global(bs["boundary"], device),
        "image_t": put_global(bt["image"], device),
    }


def host_fed_window(step, state, gen, device, steps: int, lr_gen: float = 1e-3,
                    lr_dis: float = 2.5e-5, epoch: int = 30):
    """One untimed step (the workers' start and the first prefetch), then
    ``steps`` host-fed train steps timed end to end. Returns (ms per step,
    the state)."""
    bs, bt = next(gen)
    state, metrics = step(state, device_batch(bs, bt, device), lr_gen, lr_dis, epoch)
    float(metrics["loss_all"])
    t0 = time.perf_counter()
    for _ in range(steps):
        bs, bt = next(gen)
        state, metrics = step(state, device_batch(bs, bt, device), lr_gen, lr_dis, epoch)
    float(metrics["loss_all"])
    return (time.perf_counter() - t0) / steps * 1000.0, state


def pure_load_ms(gen, steps: int, drain: int | None = None, workers: int = 1,
                 prefetch: int = 2) -> float:
    """The loaders alone (augmentation and collation, no device work): mean
    ms per pulled batch pair.

    ``drain`` untimed pulls come first. A caller reuses the generator of a
    preceding ``host_fed_window``, whose device-bound steps left each
    loader's queue full (``prefetch`` batches, plus one finished batch per
    worker blocked on the put): those return at once and would deflate the
    number. ``drain=None`` sizes it from that model, ``prefetch + workers +
    1``, so more workers drain their deeper backlog."""
    if drain is None:
        drain = prefetch + workers + 1
    for _ in range(drain):
        next(gen)
    t0 = time.perf_counter()
    for _ in range(steps):
        next(gen)
    return (time.perf_counter() - t0) / steps * 1000.0
