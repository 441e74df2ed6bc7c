"""Segmentation metric helpers; copy of ``pq3d_tpu/utils/metric_utils.py``.

ConfusionMatrix for semantic-segmentation style IoU/accuracy bookkeeping,
and the boolean mask IoU.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ConfusionMatrix:
    """Streaming confusion matrix over `num_classes` labels.

    `add(pred, gt)` ignores entries where gt == ignore_label; `metrics()`
    returns mIoU and overall / mean accuracy, `per_class_iou()` the
    per-class IoU.
    """

    def __init__(self, num_classes: int, ignore_label: int = -100):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.mat = np.zeros((num_classes, num_classes), np.int64)

    def reset(self) -> None:
        self.mat[:] = 0

    def add(self, pred: np.ndarray, gt: np.ndarray) -> None:
        pred = np.asarray(pred).ravel()
        gt = np.asarray(gt).ravel()
        keep = (gt != self.ignore_label) & (gt >= 0) & \
            (gt < self.num_classes)
        pred = np.clip(pred[keep], 0, self.num_classes - 1)
        gt = gt[keep]
        idx = gt * self.num_classes + pred
        self.mat += np.bincount(idx, minlength=self.num_classes ** 2
                                ).reshape(self.num_classes, self.num_classes)

    def metrics(self) -> Dict[str, float]:
        tp = np.diag(self.mat).astype(np.float64)
        gt_tot = self.mat.sum(1).astype(np.float64)
        pred_tot = self.mat.sum(0).astype(np.float64)
        union = gt_tot + pred_tot - tp
        with np.errstate(invalid="ignore", divide="ignore"):
            iou = np.where(union > 0, tp / union, np.nan)
            acc = np.where(gt_tot > 0, tp / gt_tot, np.nan)
        total = self.mat.sum()
        return {
            "miou": float(np.nan_to_num(np.nanmean(iou))),
            "macc": float(np.nan_to_num(np.nanmean(acc))),
            "oacc": float(tp.sum() / max(total, 1)),
        }

    def per_class_iou(self) -> np.ndarray:
        tp = np.diag(self.mat).astype(np.float64)
        union = self.mat.sum(1) + self.mat.sum(0) - tp
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(union > 0, tp / union, np.nan)


def mask_iou(a: np.ndarray, b: np.ndarray,
             weights: Optional[np.ndarray] = None) -> float:
    """Boolean mask IoU, optionally element-weighted (segment sizes)."""
    a = np.asarray(a, bool)
    b = np.asarray(b, bool)
    if weights is None:
        inter = np.sum(a & b)
        union = np.sum(a | b)
    else:
        inter = np.sum(weights * (a & b))
        union = np.sum(weights * (a | b))
    return float(inter / max(union, 1e-9))
