"""Host-side prediction post-processing (own copy of
uda_clr_tpu/utils/postprocess.py, the reference's utils/Utils.py:427-474).

scipy-only re-implementation (the environment has no skimage):
``diamond(7)`` structuring element, 5x median filter (7x7), binary erosion,
largest-connected-component + fill-holes. Threshold contract preserved:
Drishti-* datasets use disc>0.5 / cup>0.1, everything else a single
threshold (default 0.75).

Array convention: ``prediction`` is channel-last [H, W, 2] probabilities
(ch0=cup, ch1=disc); returns binarized [H, W, 2] float array.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage as ndi
import scipy.signal


def diamond(radius: int) -> np.ndarray:
    """Diamond (L1-ball) structuring element, matching skimage.morphology.diamond."""
    l = 2 * radius + 1
    y, x = np.mgrid[0:l, 0:l]
    return (np.abs(x - radius) + np.abs(y - radius) <= radius).astype(np.uint8)


def get_largest_fillhole(binary: np.ndarray) -> np.ndarray:
    """Keep the largest connected component, fill its holes
    (reference Utils.py:427-436)."""
    binary = np.asarray(binary).astype(np.uint8).copy()
    labeled, n = ndi.label(binary)
    if n > 0:
        sizes = ndi.sum(binary, labeled, index=np.arange(1, n + 1))
        idx_max = int(np.argmax(sizes)) + 1
        binary[labeled != idx_max] = 0
    return ndi.binary_fill_holes(binary.astype(int))


def _clean(mask: np.ndarray) -> np.ndarray:
    mask = mask.astype(np.uint8)
    for _ in range(5):
        mask = scipy.signal.medfilt2d(mask, 7)
    mask = ndi.binary_erosion(mask, structure=diamond(7)).astype(np.uint8)
    return get_largest_fillhole(mask).astype(np.uint8)


def postprocessing(
    prediction: np.ndarray, threshold: float = 0.75, dataset: str = "G"
) -> np.ndarray:
    """Reference Utils.py:438-474. ``dataset`` starting with 'D'
    (Drishti-GS) binarizes disc>0.5 / cup>0.1; otherwise ``> threshold``."""
    prediction = np.asarray(prediction, dtype=np.float32)
    cup = prediction[..., 0]
    disc = prediction[..., 1]
    if dataset and dataset[0] == "D":
        disc_mask = (disc > 0.5).astype(np.uint8)
        cup_mask = (cup > 0.1).astype(np.uint8)
    else:
        disc_mask = (disc > threshold).astype(np.uint8)
        cup_mask = (cup > threshold).astype(np.uint8)
    out = np.empty_like(prediction)
    out[..., 0] = _clean(cup_mask)
    out[..., 1] = _clean(disc_mask)
    return out
