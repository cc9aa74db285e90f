"""Synthetic fundus-like dataset for tests and benchmarks (own copy of
uda_clr_tpu/data/synthetic.py, holding numpy arrays where that module holds
PIL images; the samples are bitwise the same).

ROI-style crops with a bright disc ellipse and an inner cup ellipse on a
textured background, in the real datasets' grayscale label encoding
(background 255, disc rim 128, cup 0).
"""

from __future__ import annotations

import numpy as np


def make_sample(rng: np.random.Generator, size: int = 512):
    h = w = size
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = rng.uniform(0.35, 0.65, 2) * size
    disc_r = rng.uniform(0.18, 0.28) * size
    cup_r = disc_r * rng.uniform(0.4, 0.7)
    ar = rng.uniform(0.8, 1.2)
    disc = ((yy - cy) ** 2 * ar + (xx - cx) ** 2 / ar) < disc_r**2
    cup = ((yy - cy) ** 2 * ar + (xx - cx) ** 2 / ar) < cup_r**2

    base = rng.uniform(60, 120)
    img = np.zeros((h, w, 3), dtype=np.float32)
    img[..., 0] = base + 60
    img[..., 1] = base
    img[..., 2] = base * 0.5
    noise = rng.normal(0, 12, (h, w, 1)).astype(np.float32)
    img += noise
    img[disc] += np.array([70, 60, 40], dtype=np.float32)
    img[cup] += np.array([40, 35, 20], dtype=np.float32)
    img = np.clip(img, 0, 255).astype(np.uint8)

    label = np.full((h, w), 255, dtype=np.uint8)
    label[disc] = 128
    label[cup] = 0
    return img, label


class SyntheticFundus:
    def __init__(self, n: int = 16, size: int = 512, seed: int = 0, transform=None):
        rng = np.random.default_rng(seed)
        self.image_pool, self.label_pool, self.img_name_pool = [], [], []
        for i in range(n):
            img, lbl = make_sample(rng, size)
            self.image_pool.append(img)
            self.label_pool.append(lbl)
            self.img_name_pool.append(f"synthetic_{i:04d}.png")
        self.transform = transform

    def __len__(self):
        return len(self.image_pool)

    def __getitem__(self, index):
        return {
            "image": self.image_pool[index],
            "label": self.label_pool[index],
            "img_name": self.img_name_pool[index],
        }

    def get(self, index, rng: np.random.Generator):
        sample = self[index]
        if self.transform is not None:
            sample = self.transform(sample, rng)
        return sample
