"""ctypes bindings of the native host augmentation (own copy of
uda_clr_tpu/data/native.py over ``csrc/fundus_aug.cpp``).

The library is built with g++ at first use into ``build/host/``
(:class:`uda_clr_tpu_torch.ops.cuda_build.HostLibrary`, native/Makefile's
flags, so the port's library and the JAX package's give the same bits on
one machine). It is the default path of :mod:`uda_clr_tpu_torch.data.transforms`.

Unlike the JAX package, which falls back to scipy silently, a library
that does not build raises, with the compiler's output. The scipy
formulations below are the explicit off path: ``set_enabled(False)``, or
``UDA_TORCH_NATIVE=0`` in the environment. Native differs from scipy by at
most 1 on some uint8 pixels of the elastic warp (the float32 smoothing of
the displacement fields); the boundary ring and a float64 ``gaussian2d``
are equal.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import scipy.ndimage as ndi

from uda_clr_tpu_torch.ops.cuda_build import INT, HostLibrary

ENV_VAR = "UDA_TORCH_NATIVE"

_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_F8 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_D = ctypes.c_double
LIBRARY = HostLibrary("fundus_aug.cpp", {
    "fundus_gaussian2d": [_F8, INT, INT, _D, INT],
    "fundus_elastic": [_U8, _U8, _F8, _F8, INT, INT, _D, _D, _U8, _U8],
    "fundus_boundary_ring": [_U8, INT, INT, INT, _U8],
})

_lock = threading.Lock()
_enabled: bool | None = None  # None: from the environment at first use
_announced = False


def _lib():
    """The loaded library, or None when native is off; raises if it is on
    and does not build. Once settled, it takes no lock (the loader's
    threads and forked workers call it per sample)."""
    global _enabled, _announced
    if _announced and _enabled is not None and (LIBRARY.lib is not None or not _enabled):
        return LIBRARY.lib if _enabled else None
    with _lock:
        if _enabled is None:
            _enabled = os.environ.get(ENV_VAR, "1") != "0"
        lib = LIBRARY.load() if _enabled else None
        if not _announced:
            _announced = True
            print(f"host augmentation: native {LIBRARY.so_path().name}" if lib is not None
                  else f"host augmentation: scipy (native off: set_enabled(False) or "
                       f"{ENV_VAR}=0)", flush=True)
        return lib


def available() -> bool:
    """Whether the native path runs (it raises if on and unbuildable)."""
    return _lib() is not None


def set_enabled(enabled: bool) -> None:
    """Turn the native library on (build and load it now) or off (the
    scipy formulations everywhere)."""
    global _enabled, _announced
    with _lock:
        _enabled, _announced = bool(enabled), False
    _lib()


def gaussian2d(field: np.ndarray, sigma: float, mode: str = "constant") -> np.ndarray:
    """Separable gaussian of a [h, w] float64 field (a copy)."""
    lib = _lib()
    out = np.ascontiguousarray(field, dtype=np.float64).copy()
    if lib is None:
        return ndi.gaussian_filter(out, sigma, mode=mode, cval=0)
    lib.fundus_gaussian2d(out, out.shape[0], out.shape[1], float(sigma),
                          0 if mode == "constant" else 1)
    return out


def elastic(image: np.ndarray, label: np.ndarray, rand_x: np.ndarray,
            rand_y: np.ndarray, alpha: float, sigma: float):
    """Elastic deformation from the raw U(-1,1) fields: gaussian-smoothed
    displacements, a bilinear image warp (constant-0 border) and a
    clamped-bilinear label warp; returns (image', label') uint8."""
    lib = _lib()
    h, w = label.shape
    if lib is None:
        dx = ndi.gaussian_filter(rand_x, sigma, mode="constant", cval=0) * alpha
        dy = ndi.gaussian_filter(rand_y, sigma, mode="constant", cval=0) * alpha
        x, y = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        idx = (np.reshape(x + dx, (-1, 1)), np.reshape(y + dy, (-1, 1)))
        out_img = np.zeros((h, w, 3))
        for c in range(3):
            out_img[:, :, c] = ndi.map_coordinates(image[:, :, c], idx, order=1).reshape(h, w)
        out_lbl = ndi.map_coordinates(label, idx, order=1, mode="nearest").reshape(h, w)
        return out_img.astype(np.uint8), out_lbl.astype(np.uint8)
    img = np.ascontiguousarray(image, np.uint8)
    lbl = np.ascontiguousarray(label, np.uint8)
    rx = np.ascontiguousarray(rand_x, np.float64).copy()
    ry = np.ascontiguousarray(rand_y, np.float64).copy()
    if img.shape != (h, w, 3) or rx.shape != (h, w) or ry.shape != (h, w):
        raise ValueError(f"elastic: image {img.shape}, fields {rx.shape} {ry.shape} for a "
                         f"label of {(h, w)}")
    out_img = np.empty_like(img)
    out_lbl = np.empty_like(lbl)
    lib.fundus_elastic(img, lbl, rx, ry, h, w, float(alpha), float(sigma), out_img, out_lbl)
    return out_img, out_lbl


def boundary_ring(mask2: np.ndarray, iters: int = 5) -> np.ndarray:
    """Cup+disc boundary ring: the union over both channels of dilation XOR
    erosion (cross-shaped element, ``iters`` times)."""
    lib = _lib()
    m = np.ascontiguousarray((mask2 > 0).astype(np.uint8))
    if m.ndim != 3 or m.shape[2] != 2:
        raise ValueError(f"boundary_ring takes a [h, w, 2] mask, got {m.shape}")
    h, w = m.shape[:2]
    out = np.zeros((h, w), np.uint8)
    if lib is None:
        for ch in range(2):
            a = m[..., ch]
            dil = ndi.binary_dilation(a, iterations=iters)
            ero = ndi.binary_erosion(a, iterations=iters)
            out |= (dil.astype(np.uint8) + ero.astype(np.uint8) == 1).astype(np.uint8)
        return out
    lib.fundus_boundary_ring(m, h, w, iters, out)
    return out
