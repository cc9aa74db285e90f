"""Fundus ROI segmentation dataset (own copy of uda_clr_tpu/data/fundus.py;
reference dataloaders/fundus_dataloader.py), reading its PNGs with the
port's zlib/numpy reader (data/png.py) into numpy arrays.

Directory layout: ``{base}/{dataset}/{split}/ROIs/image/*.png`` with labels
at ``.../ROIs/mask/*.png``; images are decoded once into RAM. The layout is
validated fail-fast, naming the first missing path level, and a mask is the
same-named file in the sibling ``ROIs/mask`` directory (the reference's
``path.replace('image','mask')`` rewrites every "image" in the path).
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from uda_clr_tpu_torch.data.png import read_mask, read_rgb


def _mask_path(image_path: str) -> str:
    """Same-named label in the sibling ``ROIs/mask`` directory (immune to
    'image' appearing elsewhere in the tree, unlike the reference's global
    str.replace — fundus_dataloader.py:40)."""
    return os.path.join(os.path.dirname(os.path.dirname(image_path)),
                        "mask", os.path.basename(image_path))


def validate_layout(base_dir: str, dataset: str, split: str) -> list[str]:
    """Fail-fast dataset-layout validator.

    Checks the expected on-disk layout
    ``{base_dir}/{dataset}/{split}/ROIs/image/*.png`` (+ a sibling
    ``mask/`` directory with one same-named label per image — the
    reference's convention, dataloaders/fundus_dataloader.py:26-48) and
    raises a FileNotFoundError that names the FIRST missing path level and
    what actually exists there, so a mis-mounted data volume is diagnosed
    in one read instead of a bare "no images" error.

    Returns the sorted image paths on success.
    """
    expected = os.path.join(base_dir, dataset, split, "ROIs", "image")

    def _listing(d: str) -> str:
        try:
            entries = sorted(os.listdir(d))
        except OSError as e:
            return f"<unlistable: {e}>"
        shown = ", ".join(entries[:10]) or "<empty>"
        more = f", ... ({len(entries)} total)" if len(entries) > 10 else ""
        return shown + more

    # walk down the expected path; report the first missing component
    parts = [base_dir, dataset, split, "ROIs", "image"]
    path = ""
    for i, part in enumerate(parts):
        path = part if i == 0 else os.path.join(path, part)
        if not os.path.isdir(path):
            parent = os.path.dirname(path) if i else os.path.dirname(os.path.abspath(path))
            raise FileNotFoundError(
                f"dataset layout error: expected {expected}/*.png "
                f"(layout {{root}}/{{dataset}}/{{split}}/ROIs/{{image,mask}}); "
                f"missing directory {path!r} — its parent {parent!r} contains: "
                f"{_listing(parent)}"
            )
    image_paths = sorted(glob(os.path.join(expected, "*.png")))
    if not image_paths:
        raise FileNotFoundError(
            f"dataset layout error: {expected!r} exists but holds no *.png "
            f"images; it contains: {_listing(expected)}"
        )
    mask_dir = os.path.join(base_dir, dataset, split, "ROIs", "mask")
    if not os.path.isdir(mask_dir):
        raise FileNotFoundError(
            f"dataset layout error: images found but the label directory "
            f"{mask_dir!r} is missing; {os.path.dirname(mask_dir)!r} contains: "
            f"{_listing(os.path.dirname(mask_dir))}"
        )
    missing = [p for p in image_paths if not os.path.exists(_mask_path(p))]
    if missing:
        raise FileNotFoundError(
            f"dataset layout error: {len(missing)}/{len(image_paths)} images "
            f"have no same-named mask under {mask_dir!r} "
            f"(first: {os.path.basename(missing[0])!r})"
        )
    return image_paths


class FundusSegmentation:
    def __init__(self, base_dir: str, dataset: str = "refuge", split: str = "train",
                 transform=None):
        self._base_dir = base_dir
        self.dataset = dataset
        self.split = split
        self.transform = transform
        self._image_dir = os.path.join(base_dir, dataset, split, "ROIs", "image")
        image_paths = validate_layout(base_dir, dataset, split)
        self.image_pool: list[np.ndarray] = []
        self.label_pool: list[np.ndarray] = []
        self.img_name_pool: list[str] = []
        for image_path in image_paths:
            gt_path = _mask_path(image_path)
            self.image_pool.append(read_rgb(image_path))
            self.label_pool.append(read_mask(gt_path))
            self.img_name_pool.append(os.path.basename(image_path))

    def __len__(self) -> int:
        return len(self.image_pool)

    def __getitem__(self, index: int):
        sample = {
            "image": self.image_pool[index],
            "label": self.label_pool[index],
            "img_name": self.img_name_pool[index],
        }
        return sample

    def get(self, index: int, rng: np.random.Generator):
        sample = self[index]
        if self.transform is not None:
            sample = self.transform(sample, rng)
        return sample

    def __str__(self) -> str:
        return f"Fundus(dataset={self.dataset}, split={self.split}, n={len(self)})"
