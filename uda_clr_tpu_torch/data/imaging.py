"""The Pillow image operations the transforms use, on HWC (or HW) uint8
numpy arrays, bit-equal to Pillow's 8-bit modes ``L`` and ``RGB`` (and to
the palette indices of a ``P`` image, for the crops, pads, flips and the
nearest resize a mask goes through).

* ``resize`` with ``"bilinear"`` and ``"bicubic"`` follows Pillow's
  separable fixed-point resampler (``libImaging/Resample.c``): per output
  pixel, filter weights over a support that grows with the shrink factor,
  normalised in double precision, scaled to 22 fractional bits and rounded
  away from zero; a horizontal pass, then a vertical one, each only where
  its side changes; each sum starts at ``1 << 21``, is shifted right by 22
  and clipped to 8 bits.
* ``resize`` with ``"nearest"`` follows ``ImagingScaleAffine``
  (``libImaging/Geometry.c``): the source coordinate starts at ``step/2``
  and advances by repeated float64 addition of ``step = in/out``; the index
  is its truncation.
* ``rotate90`` covers ``Image.rotate(k * 90, expand=False)`` of a square
  image, which Pillow carries out as an exact transpose.
"""

from __future__ import annotations

import math

import numpy as np

_PRECISION_BITS = 22


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _coefficients(in_size: int, out_size: int, filt, support: float):
    """Per output index: first source index, tap count and the 22-bit
    integer weights [out_size, ksize] (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    k = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for x in range(ksize):  # the weight sum accumulates in tap order, as in C
        w = np.where(x < xmax, filt(((x + xmin) - center + 0.5) * ss), 0.0)
        k[:, x] = w
        ww = ww + w
    k = np.where((ww != 0.0)[:, None], k / np.where(ww != 0.0, ww, 1.0)[:, None], k)
    scaled = k * (1 << _PRECISION_BITS)
    ik = np.trunc(np.where(k < 0, -0.5 + scaled, 0.5 + scaled)).astype(np.int64)
    return xmin, ik


def _resample_axis(img: np.ndarray, axis: int, out_size: int, method: str) -> np.ndarray:
    filt, support = _FILTERS[method]
    in_size = img.shape[axis]
    xmin, ik = _coefficients(in_size, out_size, filt, support)
    ksize = ik.shape[1]
    idx = np.minimum(xmin[:, None] + np.arange(ksize), in_size - 1)  # weight 0 past xmax
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # [in, ...]
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    w_shape = (out_size,) + (1,) * (src.ndim - 1)
    for x in range(ksize):
        acc += src[idx[:, x]] * ik[:, x].reshape(w_shape)
    out = np.where(acc >= (1 << _PRECISION_BITS << 8), 255,
                   np.where(acc <= 0, 0, acc >> _PRECISION_BITS)).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    step = float(in_size) / out_size
    pos = np.empty(out_size)
    pos[0] = step * 0.5
    pos[1:] = step
    pos = np.add.accumulate(pos)  # sequential float64 sums, as the C loop
    idx = np.where(pos < 0.0, -1, np.trunc(pos)).astype(np.int64)
    return idx


def resize(img: np.ndarray, size: tuple[int, int], method: str = "bicubic") -> np.ndarray:
    """``Image.resize((w, h), method)``; Pillow's default resample is
    bicubic. ``size`` is (width, height) as in Pillow."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize takes uint8 images, got {img.dtype}")
    out_w, out_h = int(size[0]), int(size[1])
    if out_w <= 0 or out_h <= 0:
        raise ValueError(f"resize to {size}: sides must be positive")
    in_h, in_w = img.shape[:2]
    if (out_w, out_h) == (in_w, in_h):
        return img.copy()
    if method == "nearest":
        xi, yi = _nearest_index(in_w, out_w), _nearest_index(in_h, out_h)
        out = np.zeros((out_h, out_w) + img.shape[2:], np.uint8)
        okx = (xi >= 0) & (xi < in_w)
        oky = (yi >= 0) & (yi < in_h)
        out[np.ix_(oky, okx)] = img[np.ix_(yi[oky], xi[okx])]
        return out
    if method not in _FILTERS:
        raise ValueError(f"resize method {method!r}; one of nearest, bilinear, bicubic")
    out = img
    if out_w != in_w:
        out = _resample_axis(out, 1, out_w, method)
    if out_h != in_h:
        out = _resample_axis(out, 0, out_h, method)
    return out


def expand(img: np.ndarray, border: int, fill: int) -> np.ndarray:
    """``ImageOps.expand(img, border, fill)``: pad every side by ``border``.
    As in Pillow, an integer ``fill`` of a multi-channel image is a packed
    pixel: channel c takes byte c of it (so 0 is black)."""
    img = np.asarray(img)
    out = np.empty((img.shape[0] + 2 * border, img.shape[1] + 2 * border) + img.shape[2:],
                   img.dtype)
    if img.ndim == 2:
        out[...] = fill
    else:
        out[...] = [(fill >> (8 * c)) & 0xFF for c in range(img.shape[2])]
    out[border:border + img.shape[0], border:border + img.shape[1]] = img
    return out


def crop(img: np.ndarray, box: tuple[int, int, int, int]) -> np.ndarray:
    """``img.crop((x1, y1, x2, y2))``; area outside the image is 0."""
    img = np.asarray(img)
    x1, y1, x2, y2 = (int(v) for v in box)
    h, w = img.shape[:2]
    out = np.zeros((max(y2 - y1, 0), max(x2 - x1, 0)) + img.shape[2:], img.dtype)
    sx1, sy1, sx2, sy2 = max(x1, 0), max(y1, 0), min(x2, w), min(y2, h)
    if sx2 > sx1 and sy2 > sy1:
        out[sy1 - y1:sy2 - y1, sx1 - x1:sx2 - x1] = img[sy1:sy2, sx1:sx2]
    return out


def flip_left_right(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(img)[:, ::-1])


def flip_top_bottom(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(img)[::-1])


def rotate90(img: np.ndarray, angle: int) -> np.ndarray:
    """``img.rotate(angle, expand=False)`` for a multiple of 90 degrees
    (counter-clockwise): a transpose for a square image, whatever the
    resample filter."""
    img = np.asarray(img)
    if angle % 90:
        raise ValueError(f"rotate90 takes multiples of 90 degrees, got {angle}")
    k = (angle // 90) % 4
    if k % 2 and img.shape[0] != img.shape[1]:
        raise NotImplementedError("a quarter turn of a non-square image resamples in Pillow")
    return np.ascontiguousarray(np.rot90(img, k))
