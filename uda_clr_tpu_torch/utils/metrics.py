"""Evaluation metrics (own copy of uda_clr_tpu/utils/metrics.py), host-side
numpy as the reference's utils/metrics.py: Dice with +1 smoothing after
sigmoid and threshold 0.75 (:118-132), and 2-class confusion-matrix pixel
accuracy / mIoU (:5-59,149-167).

Arrays are channel-last: ``pred`` are *logits* [B, H, W, 2] and ``target``
binary maps [B, H, W, 2] (ch0 = cup, ch1 = disc).
"""

from __future__ import annotations

import numpy as np


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def dice_coefficient_numpy(binary_segmentation: np.ndarray, binary_gt_label: np.ndarray) -> float:
    """Dice with +1 smoothing in both numerator and denominator
    (reference utils/metrics.py:71-100)."""
    seg = np.asarray(binary_segmentation, dtype=bool)
    gt = np.asarray(binary_gt_label, dtype=bool)
    intersection = float(np.sum(np.logical_and(seg, gt)))
    seg_pixels = float(np.sum(seg))
    gt_pixels = float(np.sum(gt))
    return (2.0 * intersection + 1.0) / (1.0 + seg_pixels + gt_pixels)


def dice_coeff_2label(pred_logits: np.ndarray, target: np.ndarray, threshold: float = 0.75):
    """(cup_dice, disc_dice) after sigmoid & ``> threshold`` binarization
    (reference utils/metrics.py:118-132; note strictly-greater)."""
    p = sigmoid(np.asarray(pred_logits, dtype=np.float32)) > threshold
    t = np.asarray(target)
    return (
        dice_coefficient_numpy(p[..., 0], t[..., 0]),
        dice_coefficient_numpy(p[..., 1], t[..., 1]),
    )


def dice_coeff(pred_logits: np.ndarray, target: np.ndarray) -> float:
    """Single-structure Dice at threshold 0.5 (utils/metrics.py:103-116)."""
    p = sigmoid(np.asarray(pred_logits, dtype=np.float32)) > 0.5
    return dice_coefficient_numpy(p, np.asarray(target))


class SegmentationMetric:
    """Streaming confusion matrix (reference utils/metrics.py:5-59)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.confusion = np.zeros((num_classes, num_classes), dtype=np.float64)

    def add_batch(self, pred: np.ndarray, label: np.ndarray) -> None:
        pred = np.asarray(pred).astype(np.int64).ravel()
        label = np.asarray(label).astype(np.int64).ravel()
        mask = (label >= 0) & (label < self.num_classes)
        idx = self.num_classes * label[mask] + pred[mask]
        count = np.bincount(idx, minlength=self.num_classes**2)
        self.confusion += count.reshape(self.num_classes, self.num_classes)

    def pixel_accuracy(self) -> float:
        return float(np.diag(self.confusion).sum() / self.confusion.sum())

    def mean_iou(self) -> float:
        inter = np.diag(self.confusion)
        union = self.confusion.sum(1) + self.confusion.sum(0) - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = inter / union
        return float(np.nanmean(iou))

    def reset(self) -> None:
        self.confusion[:] = 0


def pixel_acc(pred_logits: np.ndarray, target: np.ndarray, threshold: float = 0.75):
    """(PA_cup, PA_disc, IoU_cup, IoU_disc) at threshold 0.75
    (reference utils/metrics.py:149-167)."""
    p = (sigmoid(np.asarray(pred_logits, dtype=np.float32)) > threshold).astype(np.int64)
    t = np.asarray(target).astype(np.int64)
    m_cup, m_disc = SegmentationMetric(2), SegmentationMetric(2)
    m_disc.add_batch(p[..., 1], t[..., 1])
    m_cup.add_batch(p[..., 0], t[..., 0])
    return (
        m_cup.pixel_accuracy(),
        m_disc.pixel_accuracy(),
        m_cup.mean_iou(),
        m_disc.mean_iou(),
    )
