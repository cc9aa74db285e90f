"""Batched, prefetching host input pipeline (own copy of
uda_clr_tpu/data/pipeline.py), numpy only.

Two worker models:

* ``backend="thread"`` - a ``ThreadPoolExecutor`` runs the transform
  pipeline (numpy/scipy code that largely releases the GIL); no IPC.
* ``backend="process"`` - a fork-context ``multiprocessing.Pool``, the
  reference's ``DataLoader(num_workers=6)`` worker processes; samples come
  back pickled.

A background producer thread keeps a bounded queue of ready batches, and
the per-sample augmentation rng is derived from ``(seed, epoch, batch, j)``,
so both backends and any worker count give bit-identical streams. Under
data parallelism (``process_index``/``process_count``) ``j`` is the
sample's position in the global batch, so the union of the ranks' streams
is the single-process stream bit for bit.

Fork caveat: the workers are forked from a parent that may hold a CUDA
context. They touch numpy and scipy only, never torch, and the datasets
they inherit hold numpy arrays only; torch's own DataLoader relies on the
same discipline under CUDA.

The trainer moves batches to the device (``torch.from_numpy(...).to``);
uint8 wire batches cross as uint8 and decode there (data/wire.py).
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from uda_clr_tpu_torch.parallel.mesh import local_stripe

_BATCH_KEYS = ("image", "map", "boundary")

# fork-inherited dataset handle for process-backend workers: passed once
# through Pool(initargs=...) (inherited by fork, not pickled) so per-task
# IPC carries only (index, seed-tuple) down and one sample dict back up
_WORKER_DATASET = None


def _process_worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _process_worker_get(task):
    idx, seed_key = task
    return _WORKER_DATASET.get(idx, np.random.default_rng(seed_key))


def collate(samples) -> dict:
    batch = {}
    for k in _BATCH_KEYS:
        arr = np.stack([s[k] for s in samples])
        # uint8 wire-format batches (data/wire.py) cross host->device as-is
        # (4x fewer bytes); everything else keeps the fp32 contract
        batch[k] = arr if arr.dtype == np.uint8 else arr.astype(np.float32)
    batch["img_name"] = [s["img_name"] for s in samples]
    return batch


class BatchLoader:
    """Iterates shuffled (or sequential) batches forever or per-epoch.

    ``drop_last=True`` keeps the step's shapes static (pad-free); eval uses
    ``drop_last=False`` with a final partial batch handled host-side.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 2,
        prefetch: int = 2,
        backend: str = "thread",
        process_index: int = 0,
        process_count: int = 1,
        space_index: int = 0,
        space_count: int = 1,
    ):
        """``process_index``/``process_count``: data parallelism across
        processes (parallel/distributed.py); on the ``('data', 'space')``
        mesh the data index and ``n_data``. Every process derives the same
        global epoch order and batch composition from the shared seed, then
        loads only its ``batch_size // process_count`` slice of each global
        batch; per-sample rngs stay keyed by the global position
        ``(seed, epoch, bi, global_j)``. ``space_index``/``space_count``:
        the spatial mesh's stripes (parallel/spatial.py): the loader then
        keeps rows ``[s*H/n, (s+1)*H/n)`` of every per-pixel array, on
        either wire format. The ranks of one data index augment the same
        samples whole, each keeping its stripe: duplicate host work, n_space
        times over."""
        if backend not in ("thread", "process"):
            raise ValueError(
                f"BatchLoader backend must be 'thread' or 'process', got {backend!r}"
            )
        if process_count > 1:
            if batch_size % process_count:
                raise ValueError(
                    f"global batch_size {batch_size} must divide evenly over "
                    f"{process_count} processes"
                )
            if not drop_last:
                raise ValueError(
                    "process-sharded loading requires drop_last=True "
                    "(a partial final batch cannot split evenly)"
                )
            if not 0 <= process_index < process_count:
                raise ValueError(
                    f"process_index {process_index} out of range [0, {process_count})"
                )
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.backend = backend
        self.process_index = process_index
        self.process_count = process_count
        if not 0 <= space_index < space_count:
            raise ValueError(f"space_index {space_index} out of range [0, {space_count})")
        self.space_index = space_index
        self.space_count = space_count

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> list[list[int]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(n)
        batches = []
        for i in range(0, n - (n % self.batch_size if self.drop_last else 0), self.batch_size):
            idx = order[i : i + self.batch_size]
            if len(idx) == 0 or (self.drop_last and len(idx) < self.batch_size):
                break
            batches.append(list(idx))
        return batches

    def epoch(self, epoch: int, start: int = 0):
        """Yield one epoch of batches with background prefetch.

        ``start`` skips the first ``start`` batches without paying their
        augmentation cost; the remaining batches keep their absolute batch
        index ``bi`` (which seeds the per-sample augmentation rngs), so a
        stream entered mid-epoch is sample-exact with the full epoch.
        """
        batches = self._epoch_indices(epoch)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            # stop-aware put: a consumer that abandons the generator mid-epoch
            # sets `stop` while this thread may be parked on a full queue — a
            # blind q.put would then block forever, leaking the thread and
            # its queued batches.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        per = self.batch_size // self.process_count
        lo = self.process_index * per

        def _run(map_samples):
            for bi in range(start, len(batches)):
                if stop.is_set():
                    return False
                idx = batches[bi]
                if self.process_count > 1:
                    idx = idx[lo : lo + per]
                keys = [(self.seed, epoch, bi, lo + j) for j in range(len(idx))]
                if not _put(self._stripe(collate(map_samples(idx, keys)))):
                    return False
            return True

        def produce():
            try:
                if self.backend == "process":
                    ctx = multiprocessing.get_context("fork")
                    with ctx.Pool(
                        self.num_workers,
                        initializer=_process_worker_init,
                        initargs=(self.dataset,),
                    ) as pool:
                        done = _run(lambda idx, keys: pool.map(
                            _process_worker_get, list(zip(idx, keys))))
                else:
                    with ThreadPoolExecutor(self.num_workers) as pool:
                        done = _run(lambda idx, keys: list(pool.map(
                            lambda a: self.dataset.get(a[0], np.random.default_rng(a[1])),
                            zip(idx, keys))))
                if done:
                    _put(None)
            except BaseException as e:
                # surface dataset/transform failures to the consumer instead
                # of dying silently (which would hang q.get() forever); torch
                # DataLoader propagates worker exceptions the same way
                _put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise RuntimeError(f"BatchLoader worker failed: {item!r}") from item
                yield item
        finally:
            stop.set()

    def _stripe(self, batch: dict) -> dict:
        """This rank's stripe of rows of every per-pixel array (NHWC)."""
        if self.space_count == 1:
            return batch
        for k in _BATCH_KEYS:
            rows = local_stripe(batch[k].shape[1], self.space_index, self.space_count)
            batch[k] = np.ascontiguousarray(batch[k][:, rows])
        return batch

    def forever(self, start_batch: int = 0):
        """Endless batch stream (target-domain loader cycling,
        Trainer_prototype_full.py:279-283).

        ``start_batch`` fast-forwards the stream to the given global batch
        index (= batches already consumed) without doing the skipped
        batches' augmentation work, so a resumed run's target stream lines
        up exactly with the uninterrupted run's. Positions are only
        comparable while the dataset length is unchanged between runs.
        """
        n = len(self)
        if n == 0:
            raise ValueError(
                f"BatchLoader.forever(): dataset yields zero batches per epoch "
                f"(len(dataset)={len(self.dataset)} < batch_size="
                f"{self.batch_size} with drop_last={self.drop_last}) — an "
                f"endless stream would busy-spin without ever yielding"
            )
        epoch, off = divmod(start_batch, n)
        while True:
            yield from self.epoch(epoch, start=off)
            off = 0
            epoch += 1
