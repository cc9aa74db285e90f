"""Observability sinks (own copy of uda_clr_tpu/utils/logging.py): scalars
to tensorboard or JSONL, an append-only ``log.csv`` with the reference's
fixed 12-column header (Trainer_prototype_full.py:68-84), and per-epoch
wall time and throughput.

The trainer keeps each step's metrics as device scalars and flushes them
through these sinks once per epoch (the reference calls ``.item()`` many
times per iteration, a device sync each).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from uda_clr_tpu_torch.data.png import write_png

LOG_HEADERS = [
    "epoch",
    "iteration",
    "train/loss_seg",
    "train/cup_dice",
    "train/disc_dice",
    "train/loss_adv",
    "train/loss_D_same",
    "train/loss_D_diff",
    "valid/loss_CE",
    "valid/cup_dice",
    "valid/disc_dice",
    "elapsed_time",
]


class CsvLogger:
    def __init__(self, out_dir: str):
        self.path = os.path.join(out_dir, "log.csv")
        self.start = time.time()
        if not os.path.exists(self.path):
            os.makedirs(out_dir, exist_ok=True)
            with open(self.path, "w") as f:
                f.write(",".join(LOG_HEADERS) + "\n")

    def elapsed(self) -> float:
        return time.time() - self.start

    def write_train_rows(self, rows: list[dict]) -> None:
        """One row per iteration: epoch, iteration, train metrics, 3 blanks,
        elapsed (reference :585-592)."""
        with open(self.path, "a") as f:
            for r in rows:
                cells = [
                    r.get("epoch", ""),
                    r.get("iteration", ""),
                    r.get("loss_seg", ""),
                    r.get("cup_dice", ""),
                    r.get("disc_dice", ""),
                    r.get("loss_adv", ""),
                    r.get("loss_D", ""),
                    r.get("loss_D2", ""),
                ] + [""] * 3 + [r.get("elapsed_time", self.elapsed())]
                f.write(",".join(str(c) for c in cells) + "\n")

    def write_valid_row(self, epoch, iteration, loss, cup_dice, disc_dice, best_epoch) -> None:
        """Validation row: blanks under the six train columns, then
        loss_CE / cup_dice / disc_dice / elapsed under their headers, and
        the best-model note as a 13th overflow cell (the reference pads only
        five blanks, shifting its validation metrics one column left; the
        JAX package repaired that, and so does this copy)."""
        cells = (
            [epoch, iteration]
            + [""] * 6
            + [loss, cup_dice, disc_dice, self.elapsed(), f"best model epoch: {best_epoch}"]
        )
        with open(self.path, "a") as f:
            f.write(",".join(str(c) for c in cells) + "\n")


class ScalarWriter:
    """Tensorboard scalars and images when tensorboard imports; otherwise
    scalars to JSONL (``tensorboard/scalars.jsonl``) and images to PNGs
    (``tensorboard/images/{tag}_{step}.png``, ``/`` in the tag as ``_``)."""

    def __init__(self, out_dir: str):
        log_dir = os.path.join(out_dir, "tensorboard")
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        else:
            self._tb = SummaryWriter(log_dir=log_dir)

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        else:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")

    def add_image(self, tag: str, img, step: int) -> None:
        """Log an [H,W] / [H,W,1] / [H,W,3] image, min-max normalized to
        [0,1] like the reference's ``make_grid(..., normalize=True)``
        (Trainer_prototype_full.py:307-325); a constant image is all 0."""
        img = np.asarray(img, np.float32)
        lo, hi = float(img.min()), float(img.max())
        img = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
        if img.ndim == 3 and img.shape[-1] == 1:
            img = img[..., 0]
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats="HWC" if img.ndim == 3 else "HW")
            return
        d = os.path.join(os.path.dirname(self._jsonl.name), "images")
        os.makedirs(d, exist_ok=True)
        write_png(os.path.join(d, f"{tag.replace('/', '_')}_{step}.png"),
                  (img * 255).astype(np.uint8))

    def close(self) -> None:
        (self._tb or self._jsonl).close()


class StepTimer:
    """Wall-clock per-epoch timing plus images/sec throughput."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.images = 0

    def start(self):
        self.t0 = time.time()
        self.images = 0

    def add_images(self, n: int):
        self.images += n

    def stop(self) -> tuple[float, float]:
        dt = time.time() - (self.t0 or time.time())
        ips = self.images / dt if dt > 0 else 0.0
        return dt, ips
