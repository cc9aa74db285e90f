"""Host-side augmentation pipeline (own copy of uda_clr_tpu/data/transforms.py,
the reference's dataloaders/custom_transforms.py).

Every class of the JAX module, over :mod:`uda_clr_tpu_torch.data.imaging`
(Pillow's operations on uint8 arrays) and scipy, bitwise equal to the JAX
module: the elastic warp and the boundary ring call
:mod:`uda_clr_tpu_torch.data.native` as the JAX module calls its native
library (the native library by default, its scipy formulations when it is
turned off in both packages). Randomness comes from the
``np.random.Generator`` each call is given, drawn in the JAX module's order.

Samples are dicts. Before ``Normalize_tf``: ``{'image' [H,W,3] uint8,
'label' [H,W] uint8 (grayscale mask, or palette indices), 'img_name'}``.
``Normalize_tf`` re-keys to ``{'image', 'map' [H,W,2], 'boundary' [H,W,1],
'img_name'}``: float32 (image in [-1, 1]) or, with ``wire="u8"``, uint8
for the on-device decode (data/wire.py).

Label encoding (custom_transforms.py:443-457): mask pixels >200 ->
background, 51..200 -> disc rim (class 1), <=50 -> cup (class 2);
multilabel ch0 = cup, ch1 = disc (cup pixels set both).
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage as ndi

from uda_clr_tpu_torch.data import imaging, native


def _u8(img) -> np.ndarray:
    return np.asarray(img).astype(np.uint8, copy=False)


def _size(img) -> tuple[int, int]:
    """(width, height), Pillow's ``img.size``."""
    return img.shape[1], img.shape[0]


def to_multilabel(pre_mask: np.ndarray, classes: int = 2) -> np.ndarray:
    mask = np.zeros((pre_mask.shape[0], pre_mask.shape[1], classes))
    mask[pre_mask == 1] = [0, 1]
    mask[pre_mask == 2] = [1, 1]
    return mask


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample, rng: np.random.Generator):
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class RandomCrop:
    """Random crop with pad-to-fit (custom_transforms.py:152-182); image
    padded with 0, mask with 255 (background)."""

    def __init__(self, size, padding=0):
        self.size = (int(size), int(size)) if isinstance(size, (int, float)) else size
        self.padding = padding

    def __call__(self, sample, rng):
        img, mask = _u8(sample["image"]), _u8(sample["label"])
        w, h = _size(img)
        if self.padding > 0 or w < self.size[0] or h < self.size[1]:
            padding = int(
                np.maximum(
                    self.padding,
                    np.maximum((self.size[0] - w) // 2 + 5, (self.size[1] - h) // 2 + 5),
                )
            )
            img = imaging.expand(img, padding, 0)
            mask = imaging.expand(mask, padding, 255)
        w, h = _size(img)
        th, tw = self.size
        if (w, h) != (tw, th):
            x1 = int(rng.integers(0, w - tw + 1))
            y1 = int(rng.integers(0, h - th + 1))
            img = imaging.crop(img, (x1, y1, x1 + tw, y1 + th))
            mask = imaging.crop(mask, (x1, y1, x1 + tw, y1 + th))
        return {"image": img, "label": mask, "img_name": sample["img_name"]}


class CenterCrop:
    def __init__(self, size):
        self.size = (int(size), int(size)) if isinstance(size, (int, float)) else size

    def __call__(self, sample, rng=None):
        img, mask = _u8(sample["image"]), _u8(sample["label"])
        w, h = _size(img)
        th, tw = self.size
        x1 = int(round((w - tw) / 2.0))
        y1 = int(round((h - th) / 2.0))
        img = imaging.crop(img, (x1, y1, x1 + tw, y1 + th))
        mask = imaging.crop(mask, (x1, y1, x1 + tw, y1 + th))
        return {"image": img, "label": mask, "img_name": sample["img_name"]}


class RandomScaleCrop:
    """p=0.5 anisotropic rescale U(0.5,1.5) then RandomCrop
    (custom_transforms.py:334-355)."""

    def __init__(self, size):
        self.size = size
        self.crop = RandomCrop(size)

    def __call__(self, sample, rng):
        img, mask = _u8(sample["image"]), _u8(sample["label"])
        if rng.random() > 0.5:
            w = int(rng.uniform(0.5, 1.5) * _size(img)[0])
            h = int(rng.uniform(0.5, 1.5) * _size(img)[1])
            img = imaging.resize(img, (w, h), "bilinear")
            mask = imaging.resize(mask, (w, h), "nearest")
        return self.crop({"image": img, "label": mask, "img_name": sample["img_name"]}, rng)


class RandomRotate:
    """p=0.5 rotation by a multiple of 90 degrees, the angle drawn per call
    (the reference draws it once at construction)."""

    def __call__(self, sample, rng):
        if rng.random() > 0.5:
            k = int(rng.integers(1, 5))  # 90/180/270/360
            img = imaging.rotate90(_u8(sample["image"]), k * 90)
            mask = imaging.rotate90(_u8(sample["label"]), k * 90)
            return {"image": img, "label": mask, "img_name": sample["img_name"]}
        return sample


class RandomFlip:
    def __call__(self, sample, rng):
        img, mask = _u8(sample["image"]), _u8(sample["label"])
        if rng.random() < 0.5:
            img, mask = imaging.flip_left_right(img), imaging.flip_left_right(mask)
        if rng.random() < 0.5:
            img, mask = imaging.flip_top_bottom(img), imaging.flip_top_bottom(mask)
        return {"image": img, "label": mask, "img_name": sample["img_name"]}


class elastic_transform:
    """Simard-style elastic deformation, p=0.5
    (custom_transforms.py:95-147): alpha=2H, sigma=0.08H, through
    :func:`native.elastic`."""

    def __init__(self):
        native.available()  # build and load before a loader's workers start

    def __call__(self, sample, rng):
        img = _u8(sample["image"])
        lbl = _u8(sample["label"])
        if rng.random() > 0.5:
            shape = _size(img)
            alpha = _size(img)[1] * 2
            sigma = _size(img)[1] * 0.08
            rand_x = rng.random(shape) * 2 - 1
            rand_y = rng.random(shape) * 2 - 1
            out, out_lbl = native.elastic(img, lbl, rand_x, rand_y, alpha, sigma)
            return {"image": out, "label": out_lbl, "img_name": sample["img_name"]}
        return {"image": img, "label": lbl, "img_name": sample["img_name"]}


class add_salt_pepper_noise:
    """Salt (p=0.25) / pepper (p=0.25) speckle (custom_transforms.py:22-46),
    keeping the reference's value 1 (not 255) for 'salt'."""

    def __call__(self, sample, rng):
        image = np.asarray(sample["image"]).copy()
        amount, salt_vs_pepper = 0.004, 0.2
        num_salt = int(np.ceil(amount * image.size * salt_vs_pepper))
        num_pepper = int(np.ceil(amount * image.size * (1.0 - salt_vs_pepper)))
        seed = rng.random()
        if seed > 0.75:
            coords = [rng.integers(0, i - 1, num_salt) for i in image.shape[:2]]
            image[coords[0], coords[1], :] = 1
        elif seed > 0.5:
            coords = [rng.integers(0, i - 1, num_pepper) for i in image.shape[:2]]
            image[coords[0], coords[1], :] = 0
        return {"image": image, "label": sample["label"], "img_name": sample["img_name"]}


class adjust_light:
    """p=0.5 gamma jitter, gamma in [0.5, 3.5] via uint8 LUT
    (custom_transforms.py:48-61)."""

    def __call__(self, sample, rng):
        if rng.random() > 0.5:
            gamma = rng.random() * 3 + 0.5
            inv = 1.0 / gamma
            table = (((np.arange(256) / 255.0) ** inv) * 255).astype(np.uint8)
            image = table[np.asarray(sample["image"]).astype(np.uint8)]
            return {"image": image, "label": sample["label"], "img_name": sample["img_name"]}
        return sample


class eraser:
    """p=0.5 random erasing of the image only (custom_transforms.py:64-93)."""

    def __call__(self, sample, rng, s_l=0.02, s_h=0.06, r_1=0.3, r_2=0.6, v_l=0, v_h=255):
        if rng.random() > 0.5:
            return sample
        image = np.asarray(sample["image"]).copy()
        img_h, img_w = image.shape[:2]
        while True:
            s = rng.uniform(s_l, s_h) * img_h * img_w
            r = rng.uniform(r_1, r_2)
            w = int(np.sqrt(s / r))
            h = int(np.sqrt(s * r))
            left = int(rng.integers(0, img_w))
            top = int(rng.integers(0, img_h))
            if left + w <= img_w and top + h <= img_h:
                break
        image[top : top + h, left : left + w, :] = rng.uniform(v_l, v_h)
        return {"image": image, "label": sample["label"], "img_name": sample["img_name"]}


class GetBoundary:
    """Cup+disc boundary ring of width 5 (custom_transforms.py:414-429),
    through :func:`native.boundary_ring`."""

    def __init__(self, width=5):
        self.width = width
        native.available()

    def __call__(self, mask):
        return native.boundary_ring(mask[:, :, :2], iters=self.width)


class Normalize_tf:
    """Image -> [-1,1]; grayscale mask -> multilabel {cup,disc}; Gaussian
    boundary target on the uint8-scaled ring, with the reference's integer
    quantization of the blur (custom_transforms.py:432-466). ``wire="u8"``
    keeps all three outputs uint8 for the on-device decode."""

    def __init__(self, wire: str = "f32"):
        if wire not in ("f32", "u8"):
            raise ValueError(f"wire must be 'f32' or 'u8', got {wire!r}")
        self.wire = wire
        self.get_boundary = GetBoundary()

    def __call__(self, sample, rng=None):
        img_raw = np.asarray(sample["image"])
        __mask = _u8(sample["label"]).copy()
        _mask = np.zeros(__mask.shape[:2])
        _mask[__mask > 200] = 255
        _mask[(__mask > 50) & (__mask < 201)] = 128
        __mask[_mask == 0] = 2
        __mask[_mask == 255] = 0
        __mask[_mask == 128] = 1
        mask = to_multilabel(__mask)
        boundary_u8 = ndi.gaussian_filter(
            (self.get_boundary(mask) * 255).astype(np.uint8), sigma=3
        )
        if self.wire == "u8":
            return {
                "image": img_raw.astype(np.uint8),
                "map": mask.astype(np.uint8),
                "boundary": boundary_u8[..., None],
                "img_name": sample["img_name"],
            }
        return {
            "image": img_raw.astype(np.float32) / 127.5 - 1.0,
            "map": mask.astype(np.float32),
            "boundary": (boundary_u8 / 255.0)[..., None].astype(np.float32),
            "img_name": sample["img_name"],
        }


class FixedResize:
    """Resize to (h, w): image bilinear, mask nearest
    (custom_transforms.py:226-242)."""

    def __init__(self, size):
        self.size = tuple(reversed(size))  # (h, w) -> (w, h)

    def __call__(self, sample, rng=None):
        img = imaging.resize(_u8(sample["image"]), self.size, "bilinear")
        mask = imaging.resize(_u8(sample["label"]), self.size, "nearest")
        return {"image": img, "label": mask, "img_name": sample["img_name"]}


class Scale:
    """Resize keeping the reference's early-exit quirk
    (custom_transforms.py:245-269)."""

    def __init__(self, size):
        self.size = (int(size), int(size)) if isinstance(size, (int, float)) else size

    def __call__(self, sample, rng=None):
        img, mask = _u8(sample["image"]), _u8(sample["label"])
        w, h = _size(img)
        if (w >= h and w == self.size[1]) or (h >= w and h == self.size[0]):
            return {"image": img, "label": mask, "img_name": sample["img_name"]}
        oh, ow = self.size
        img = imaging.resize(img, (ow, oh), "bilinear")
        mask = imaging.resize(mask, (ow, oh), "nearest")
        return {"image": img, "label": mask, "img_name": sample["img_name"]}


class RandomSizedCrop:
    """Random area/aspect crop then resize (custom_transforms.py:272-312)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, sample, rng):
        img, mask = _u8(sample["image"]), _u8(sample["label"])
        for _ in range(10):
            area = _size(img)[0] * _size(img)[1]
            target_area = rng.uniform(0.45, 1.0) * area
            aspect = rng.uniform(0.5, 2)
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if rng.random() < 0.5:
                w, h = h, w
            if w <= _size(img)[0] and h <= _size(img)[1]:
                x1 = int(rng.integers(0, _size(img)[0] - w + 1))
                y1 = int(rng.integers(0, _size(img)[1] - h + 1))
                img = imaging.crop(img, (x1, y1, x1 + w, y1 + h))
                mask = imaging.crop(mask, (x1, y1, x1 + w, y1 + h))
                img = imaging.resize(img, (self.size, self.size), "bilinear")
                mask = imaging.resize(mask, (self.size, self.size), "nearest")
                return {"image": img, "label": mask, "img_name": sample["img_name"]}
        sample = Scale(self.size)({"image": img, "label": mask, "img_name": sample["img_name"]})
        return CenterCrop(self.size)(sample)


class ResizeImg:
    """Resize the image only, Pillow's default (bicubic) resampling
    (custom_transforms.py:358-372)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, sample, rng=None):
        img = imaging.resize(_u8(sample["image"]), (self.size, self.size))
        return {"image": img, "label": sample["label"], "img_name": sample["img_name"]}


class Resize:
    """Resize image and mask with Pillow's default (bicubic) resampling
    (custom_transforms.py:375-390)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, sample, rng=None):
        img = imaging.resize(_u8(sample["image"]), (self.size, self.size))
        mask = imaging.resize(_u8(sample["label"]), (self.size, self.size))
        return {"image": img, "label": mask, "img_name": sample["img_name"]}


class Normalize:
    """Mean/std normalization after /255 (custom_transforms.py:392-411)."""

    def __init__(self, mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)):
        self.mean = mean
        self.std = std

    def __call__(self, sample, rng=None):
        img = np.asarray(sample["image"]).astype(np.float32) / 255.0
        img = (img - np.float32(self.mean)) / np.float32(self.std)
        mask = np.asarray(sample["label"]).astype(np.float32)
        return {"image": img, "label": mask, "img_name": sample["img_name"]}


class Normalize_cityscapes:
    """Mean subtraction then /255 (custom_transforms.py:469-486)."""

    def __init__(self, mean=(0.0, 0.0, 0.0)):
        self.mean = mean

    def __call__(self, sample, rng=None):
        img = (np.asarray(sample["image"]).astype(np.float32) - np.float32(self.mean)) / np.float32(255.0)
        mask = np.asarray(sample["label"]).astype(np.float32)
        return {"image": img, "label": mask, "img_name": sample["img_name"]}


def train_transforms(size: int = 512, wire: str = "f32") -> Compose:
    """The reference training pipeline (train_use_fix_initial.py:150-160)."""
    return Compose(
        [
            RandomScaleCrop(size),
            RandomRotate(),
            RandomFlip(),
            elastic_transform(),
            add_salt_pepper_noise(),
            adjust_light(),
            eraser(),
            Normalize_tf(wire=wire),
        ]
    )


def eval_transforms(size: int = 512, wire: str = "f32") -> Compose:
    """The reference test pipeline (train_use_fix_initial.py:162-166)."""
    return Compose([RandomCrop(size), Normalize_tf(wire=wire)])
