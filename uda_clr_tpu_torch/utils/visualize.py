"""Visualization artifacts (own copy of uda_clr_tpu/utils/visualize.py, the
reference's utils/Utils.py:349-589) on numpy and scipy, with no cv2: the
JET heatmap is OpenCV's table built here (bitwise equal to
``cv2.applyColorMap(..., COLORMAP_JET)``), files are written with
:func:`uda_clr_tpu_torch.data.png.write_png`, and the contour overlay draws
the outline of the cleaned mask itself in place of ``cv2.findContours`` +
``cv2.drawContours(thickness=2)``.

Array convention: predictions/masks are channel-last [H, W, C] with
channel 0 = cup, channel 1 = disc; images are HWC uint8 RGB (or the
pipeline's [-1, 1] floats, see ``untransform``). Heatmaps are returned in
OpenCV's BGR order, as the JAX module returns them; every file holds the
same pixels, once decoded, as the JAX module's file of the same path.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.ndimage as ndi
import scipy.signal

from uda_clr_tpu_torch.data.png import write_png
from uda_clr_tpu_torch.utils.postprocess import diamond, get_largest_fillhole


def _jet_table() -> np.ndarray:
    """OpenCV's COLORMAP_JET as a [256, 3] uint8 BGR table: its 256-entry
    float32 table (channel k of B, G, R = clip(1.5 - |4x - 1 - k|, 0, 1)
    at x = i/255), passed through its ``interp1`` at the same float32
    points (which perturbs entries in the last bit), scaled by 255 in
    float32 and rounded half to even."""
    x64 = np.arange(256) / 255.0
    table = np.stack([np.clip(1.5 - np.abs(4 * x64 - k), 0, 1) for k in (1, 2, 3)],
                     -1).astype(np.float32)
    x = (np.float32(0) + np.arange(256, dtype=np.float32) * np.float32(1.0 / 255)
         ).astype(np.float32)
    step = (x[1:] - x[:-1])[:, None]
    interp = np.concatenate([table[:1], table[:-1] + step * (table[1:] - table[:-1]) / step])
    return np.clip(np.rint(interp * np.float32(255)), 0, 255).astype(np.uint8)


_JET = _jet_table()


def _write(path: str, image: np.ndarray) -> None:
    write_png(path, np.ascontiguousarray(image))


def construct_color_img(prob_per_slice: np.ndarray) -> np.ndarray:
    """Grayscale probability map -> JET heatmap, [H, W, 3] uint8 BGR
    (Utils.py:349-357)."""
    v = np.clip(prob_per_slice * 255, 0, 255).astype(np.uint8)
    return _JET[v]


def normalize_ent(ent: np.ndarray) -> np.ndarray:
    """Scale entropy to ~[0,1] with the reference's fixed 0.4 divisor
    (Utils.py:360-367)."""
    return (ent - np.amin(ent)) / 0.4


def draw_ent(prediction: np.ndarray, save_root: str, name: str) -> None:
    """Save cup/disc entropy heatmaps (Utils.py:370-391); prediction
    [H,W,2] probabilities."""
    smooth = 1e-8
    for idx, sub in ((0, "cup"), (1, "disc")):
        os.makedirs(os.path.join(save_root, sub), exist_ok=True)
        p = prediction[..., idx]
        ent = normalize_ent(-p * np.log(p + smooth))
        _write(os.path.join(save_root, sub, name.split(".")[0] + ".png"),
               construct_color_img(ent)[..., ::-1])


def draw_mask(prediction: np.ndarray, save_root: str, name: str) -> None:
    """Save cup/disc probability heatmaps (Utils.py:394-411)."""
    for idx, sub in ((0, "cup"), (1, "disc")):
        os.makedirs(os.path.join(save_root, sub), exist_ok=True)
        _write(os.path.join(save_root, sub, name.split(".")[0] + ".png"),
               construct_color_img(prediction[..., idx])[..., ::-1])


def draw_boundary(boundary: np.ndarray, save_root: str, name: str) -> None:
    """Save a boundary probability heatmap (Utils.py:413-424);
    boundary [H,W] or [H,W,1]."""
    os.makedirs(os.path.join(save_root, "boundary"), exist_ok=True)
    b = boundary[..., 0] if boundary.ndim == 3 else boundary
    _write(os.path.join(save_root, "boundary", name.split(".")[0] + ".png"),
           construct_color_img(b)[..., ::-1])


def joint_val_image(image: np.ndarray, prediction: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """[image | gt overlay | cup pred overlay | disc pred overlay] strip
    (Utils.py:477-498). image HWC in [0,1]-ish, prediction/mask [H,W,2]."""
    ratio = 0.5
    h, w = mask.shape[:2]
    pred_cup = np.repeat(prediction[..., 0:1], 3, axis=-1)
    pred_disc = np.repeat(prediction[..., 1:2], 3, axis=-1)
    m = np.zeros((h, w, 3))
    m[..., 0] = mask[..., 0]
    m[..., 1] = mask[..., 1]
    rows = [
        image,
        ratio * image + (1 - ratio) * m,
        ratio * image + (1 - ratio) * pred_cup,
        ratio * image + (1 - ratio) * pred_disc,
    ]
    return np.concatenate(rows, axis=1)


def save_val_img(path: str, epoch: int, imgs: list[np.ndarray]) -> None:
    """Stack joint_val_image strips vertically into
    visualization/epoch_N.png (Utils.py:501-510)."""
    out_dir = os.path.join(path, "visualization")
    os.makedirs(out_dir, exist_ok=True)
    stack = np.concatenate(imgs, axis=0)
    stack = np.clip(stack * 255, 0, 255).astype(np.uint8)
    _write(os.path.join(out_dir, f"epoch_{epoch}.png"), stack)


def _clean_mask(m: np.ndarray, threshold: float) -> np.ndarray:
    m = (m > threshold).astype(np.uint8)
    for _ in range(5):
        m = scipy.signal.medfilt2d(m, 7)
    m = ndi.binary_erosion(m, structure=diamond(7)).astype(np.uint8)
    m = get_largest_fillhole(m).astype(np.uint8)
    m = ndi.binary_dilation(m, structure=diamond(7)).astype(np.uint8)
    return get_largest_fillhole(m).astype(np.uint8)


def outline(mask: np.ndarray) -> np.ndarray:
    """A 2-pixel outline of a filled mask, standing in for OpenCV's
    external contour drawn with thickness 2: the mask's pixels with a
    background pixel among their 8 neighbours (the contour's pixels),
    widened by one pixel along the 4-neighbourhood."""
    m = np.asarray(mask).astype(bool)
    border = m & ~ndi.binary_erosion(m, structure=np.ones((3, 3)), border_value=0)
    return ndi.binary_dilation(border, structure=ndi.generate_binary_structure(2, 1))


def save_per_img(patch_image: np.ndarray, data_save_path: str, img_name: str,
                 prob_map: np.ndarray, ext: str = "png") -> None:
    """Save the original ROI and a contour overlay (cup green, disc blue)
    (Utils.py:515-585). ``prob_map`` [H,W,2] with ch0=cup, ch1=disc —
    note the reference indexes [0] as disc there; we keep the package-wide
    cup-first convention. Borders are zeroed like the reference."""
    overlay_dir = os.path.join(data_save_path, "overlay")
    orig_dir = os.path.join(data_save_path, "original_image")
    os.makedirs(overlay_dir, exist_ok=True)
    os.makedirs(orig_dir, exist_ok=True)
    base = img_name.split(".")[0] + ".png"

    prob = prob_map.copy()
    prob[0, :, :] = 0
    prob[-1, :, :] = 0
    prob[:, 0, :] = 0
    prob[:, -1, :] = 0

    cup_mask = _clean_mask(prob[..., 0], 0.75)
    disc_mask = _clean_mask(prob[..., 1], 0.75)

    patch = np.asarray(patch_image).astype(np.uint8).copy()
    _write(os.path.join(orig_dir, base), patch)
    for m, color in ((cup_mask, (0, 255, 0)), (disc_mask, (0, 0, 255))):
        patch[outline(m)] = color
    _write(os.path.join(overlay_dir, base), patch)


def untransform(img: np.ndarray, lt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Invert Normalize_tf scaling (Utils.py:587-589)."""
    return (img + 1) * 127.5, lt * 128
