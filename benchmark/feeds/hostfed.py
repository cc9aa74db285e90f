"""The host feed: the program's own loaders (``data/pipeline.py``
``BatchLoader``) over fundus-like images made from the seed, each sample
augmented on the host by the program's ``train_transforms(size, wire)``,
and pulled and copied to the card as the Trainer's ``train_epoch`` does
(``train/trainer.py``): the source loader shuffled on the seed, a fresh
stream per epoch from the traffic's ``epoch`` on; the target loader
unshuffled on seed + 1, one endless stream from where an uninterrupted run
would stand at that epoch. The window opens once both loaders are as far
ahead as their prefetch queues let them run.

:meth:`Feed.replay` builds a step's batch pair again in the calling thread,
serially, with no worker and no prefetch, from the same datasets and the
loader's documented order and per-sample keys ``(seed, epoch, bi, j)``:
the reference trains on those batches, the program on what the workers
delivered, so a loader that drops, reorders or mixes samples fails the
cell's check.

Traffic keys: ``images`` (per domain), ``workers``, ``backend`` (``thread``:
the wait for full queues counts the samples made in this process), ``wire``
(``u8`` or ``f32``).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from benchmark.harness import check, inputs

_IMAGES = 3  # sub-stream of the run's seed for the images
MARGIN = 28  # source images are this much larger than the crop, as the Trainer's synthetic set
FILL_TIMEOUT_S = 600.0  # the wait for full queues raises past this


def fundus_images(seed: int, n: int, size: int, target: bool, device):
    """``n`` fundus-like images [n, size, size, 3] and label maps [n, size,
    size] (uint8, numpy; the datasets' encoding: background 255, disc rim
    128, cup 0), drawn on ``device`` in a few large calls: a bright disc
    ellipse with an inner cup on a tinted, grainy background, place, radii,
    aspect, brightness and grain drawn per image; the target domain
    brighter, bluer and flatter."""
    g = torch.Generator(device).manual_seed(inputs.substream(seed, _IMAGES + int(target)))

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, 1, 1, generator=g, device=device)

    cy, cx = u(0.35, 0.65) * size, u(0.35, 0.65) * size
    disc_r = u(0.18, 0.28) * size
    cup_r = disc_r * u(0.4, 0.7)
    ar = u(0.8, 1.2)
    base = u(70.0, 200.0) if target else u(40.0, 170.0)
    grain = u(6.0, 24.0)
    yy = torch.arange(size, device=device, dtype=torch.float32).view(1, -1, 1)
    xx = torch.arange(size, device=device, dtype=torch.float32).view(1, 1, -1)
    r = torch.sqrt((yy - cy) ** 2 * ar + (xx - cx) ** 2 / ar)  # [n, H, W]
    disc, cup = r < disc_r, r < cup_r
    del r
    b4 = base[..., None]
    tint = (b4 + 30.0, b4, b4 * 0.8) if target else (b4 + 60.0, b4, b4 * 0.5)
    img = torch.cat(tint, dim=-1)  # [n, 1, 1, 3]
    img = img + torch.randn(n, size, size, 1, generator=g, device=device) * grain[..., None]
    img = img + disc[..., None] * torch.tensor([70.0, 60.0, 40.0], device=device)
    img = img + cup[..., None] * torch.tensor([40.0, 35.0, 20.0], device=device)
    img = img.clamp(0, 255).round().to(torch.uint8).cpu().numpy()
    label = torch.full((n, size, size), 255, dtype=torch.uint8, device=device)
    label[disc] = 128
    label[cup] = 0
    return img, label.cpu().numpy()


class Images:
    """A dataset as the program's loaders take it: ``get(index, rng)`` is
    image ``index`` through ``transform`` under ``rng``; ``made`` counts
    the samples made."""

    def __init__(self, images, labels, transform):
        self.images, self.labels, self.transform = images, labels, transform
        self.made = 0
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.images)

    def get(self, index, rng):
        sample = self.transform({"image": self.images[index], "label": self.labels[index],
                                 "img_name": f"{index:04d}.png"}, rng)
        with self._lock:
            self.made += 1
        return sample


class Stream:
    """One loader's batches as ``train_epoch`` pulls them, with the
    ordinal (epoch * batches an epoch + batch) of the next pull."""

    def __init__(self, loader, first: int, endless: bool):
        self.loader, self.first, self.endless = loader, first, endless
        self.per_epoch = len(loader)
        self.next = first
        self._it = self._open()

    def _open(self):
        if self.endless:
            return self.loader.forever(start_batch=self.next)
        return self.loader.epoch(self.next // self.per_epoch, start=self.next % self.per_epoch)

    def pull(self) -> dict:
        batch = next(self._it, None)
        if batch is None:  # the source's epoch ended: the next epoch's stream
            self._it = self._open()
            batch = next(self._it)
        self.next += 1
        return batch

    def ahead(self) -> bool:
        """Whether the loader has made every batch its queue and its
        producer hold while the consumer waits: the next ``prefetch`` + 1
        batches, up to its epoch's end (the target's stream opens the
        next epoch only when pulled)."""
        epoch, off = divmod(self.next, self.per_epoch)
        last = epoch * self.per_epoch + min(off + self.loader.prefetch + 1, self.per_epoch)
        return self.loader.dataset.made >= (last - self.first) * self.loader.batch_size

    def close(self) -> None:
        self._it.close()


class Feed:
    def __init__(self, traffic: dict, config: dict, seed: int, device):
        from uda_clr_tpu_torch.data.pipeline import BatchLoader
        from uda_clr_tpu_torch.data.transforms import train_transforms

        data = config["program"]["data"]
        size, self.batch = int(data["image_size"]), int(data["batch_size"])
        n = int(traffic["images"])
        self.device = torch.device(device)
        self.seed = seed
        self.sets = [Images(*fundus_images(seed, n, size + MARGIN, t, self.device),
                            train_transforms(size, wire=traffic["wire"])) for t in (False, True)]
        if traffic["backend"] != "thread":
            raise ValueError(f"backend {traffic['backend']!r}: the wait for full queues "
                             f"counts the samples made in this process, by thread workers")
        kw = dict(num_workers=int(traffic["workers"]), backend=traffic["backend"])
        loader_s = BatchLoader(self.sets[0], self.batch, shuffle=True, seed=seed, **kw)
        loader_t = BatchLoader(self.sets[1], self.batch, shuffle=False, seed=seed + 1, **kw)
        # both streams where an uninterrupted run stands at the start of the epoch
        first = int(traffic["epoch"]) * len(loader_s)
        self.streams = (Stream(loader_s, first, False), Stream(loader_t, first, True))
        # the pull after which the window opens: set-up's checked and warm-up steps
        self.fill_at = check.STEPS + int(traffic["warmup_steps"])
        self.pulls = 0

    def replay_key(self) -> tuple:
        """The (epoch, batch) of the next pull of each stream."""
        return tuple(divmod(s.next, s.per_epoch) for s in self.streams)

    def take(self) -> dict:
        batch_s, batch_t = (s.pull() for s in self.streams)
        self.pulls += 1
        if self.pulls == self.fill_at:
            t0 = time.perf_counter()
            while not all(s.ahead() for s in self.streams):
                if time.perf_counter() - t0 > FILL_TIMEOUT_S:
                    raise RuntimeError(f"the loaders did not fill their queues in "
                                       f"{FILL_TIMEOUT_S:.0f} s")
                time.sleep(0.002)
        return self._pair(batch_s, batch_t)

    @staticmethod
    def _pair(batch_s: dict, batch_t: dict) -> dict:
        return {"image_s": batch_s["image"], "map_s": batch_s["map"],
                "boundary_s": batch_s["boundary"], "image_t": batch_t["image"]}

    def put(self, host: dict) -> dict:
        """The Trainer's copy: pinned, asynchronous on a card."""
        from uda_clr_tpu_torch.parallel.distributed import put_global

        return {k: put_global(v, self.device) for k, v in host.items()}

    def replay_host(self, key: tuple) -> dict:
        """The batch pair of ``key`` on the host, made in this thread."""
        (e_s, b_s), (e_t, b_t) = key
        return self._pair(self._rebuild(0, e_s, b_s, shuffle=True, seed=self.seed),
                          self._rebuild(1, e_t, b_t, shuffle=False, seed=self.seed + 1))

    def replay(self, key: tuple) -> dict:
        return self.put(self.replay_host(key))

    def _rebuild(self, which: int, epoch: int, bi: int, shuffle: bool, seed: int) -> dict:
        """Batch ``bi`` of ``epoch``: the epoch's order (a permutation drawn
        from ``(seed, epoch)`` when shuffled), sample j made under
        ``default_rng((seed, epoch, bi, j))``, stacked."""
        ds = self.sets[which]
        order = np.random.default_rng((seed, epoch)).permutation(len(ds)) if shuffle \
            else np.arange(len(ds))
        idx = order[bi * self.batch:(bi + 1) * self.batch]
        samples = [ds.get(int(i), np.random.default_rng((seed, epoch, bi, j)))
                   for j, i in enumerate(idx)]
        return {k: np.stack([s[k] for s in samples]) for k in ("image", "map", "boundary")}

    def close(self) -> None:
        for s in self.streams:
            s.close()
