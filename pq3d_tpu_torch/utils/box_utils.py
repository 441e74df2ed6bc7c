"""Axis-aligned 3D box IoU; copy of ``aabb_iou`` from
``pq3d_tpu/utils/box_utils.py``, what ``data/unified_pipeline.
match_gt_to_pred`` needs."""
from __future__ import annotations

import numpy as np


def aabb_iou(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """Axis-aligned IoU of (cx, cy, cz, w, h, d) boxes."""
    lo_a, hi_a = box_a[:3] - box_a[3:] / 2, box_a[:3] + box_a[3:] / 2
    lo_b, hi_b = box_b[:3] - box_b[3:] / 2, box_b[:3] + box_b[3:] / 2
    inter = np.prod(np.maximum(np.minimum(hi_a, hi_b)
                               - np.maximum(lo_a, lo_b), 0))
    va = np.prod(box_a[3:])
    vb = np.prod(box_b[3:])
    return float(inter / max(va + vb - inter, 1e-9))
