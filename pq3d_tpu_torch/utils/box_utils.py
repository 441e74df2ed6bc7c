"""3D box utilities; copy of ``pq3d_tpu/utils/box_utils.py``.

Boxes are (center xyz, size whl, heading) or 8-corner arrays.  The oriented
IoU clips convex polygons (``box3d_iou``): the exact 2D intersection in the
xy plane times the exact z overlap.  All numpy, on the host (boxes appear
only in evaluators and data preparation).
"""
from __future__ import annotations

import numpy as np


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def get_3d_box(center, size, heading: float = 0.0) -> np.ndarray:
    """(3,), (3,), angle -> (8, 3) corners, z-up."""
    w, l, h = float(size[0]), float(size[1]), float(size[2])
    x = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float32) * (w / 2)
    y = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float32) * (l / 2)
    z = np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float32) * (h / 2)
    corners = np.stack([x, y, z], 1) @ rotz(heading).T
    return corners + np.asarray(center, np.float32)


def _signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _polygon_clip(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman clip of polygon `subject` by convex `clip`
    (both normalized to counter-clockwise; edge-touching points count as
    inside so a polygon clipped by itself returns itself)."""
    if _signed_area(subject) < 0:
        subject = subject[::-1]
    if _signed_area(clip) < 0:
        clip = clip[::-1]

    def inside(p, a, b):
        return (b[0] - a[0]) * (p[1] - a[1]) - \
            (b[1] - a[1]) * (p[0] - a[0]) >= -1e-12

    def intersect(p1, p2, a, b):
        dc = a - b
        dp = p1 - p2
        n1 = a[0] * b[1] - a[1] * b[0]
        n2 = p1[0] * p2[1] - p1[1] * p2[0]
        d = dc[0] * dp[1] - dc[1] * dp[0]
        if abs(d) < 1e-12:
            return p2
        return np.array([(n1 * dp[0] - n2 * dc[0]) / d,
                         (n1 * dp[1] - n2 * dc[1]) / d])

    out = list(subject)
    a = clip[-1]
    for b in clip:
        if not out:
            return np.zeros((0, 2))
        src, out = out, []
        p_prev = src[-1]
        for p in src:
            if inside(p, a, b):
                if not inside(p_prev, a, b):
                    out.append(intersect(p_prev, p, a, b))
                out.append(p)
            elif inside(p_prev, a, b):
                out.append(intersect(p_prev, p, a, b))
            p_prev = p
        a = b
    return np.asarray(out)


def _poly_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def box3d_iou(corners1: np.ndarray, corners2: np.ndarray) -> float:
    """Oriented 3D IoU of two (8, 3) corner boxes: the exact xy polygon
    intersection times the z overlap."""
    p1 = corners1[:4, :2]
    p2 = corners2[:4, :2]
    inter_poly = _polygon_clip(p1, p2)
    inter_area = _poly_area(inter_poly)
    zmax = min(corners1[:, 2].max(), corners2[:, 2].max())
    zmin = max(corners1[:, 2].min(), corners2[:, 2].min())
    inter_vol = inter_area * max(0.0, zmax - zmin)
    v1 = _poly_area(p1) * (corners1[:, 2].max() - corners1[:, 2].min())
    v2 = _poly_area(p2) * (corners2[:, 2].max() - corners2[:, 2].min())
    return float(inter_vol / max(v1 + v2 - inter_vol, 1e-9))


def aabb_iou(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """Axis-aligned IoU of (cx, cy, cz, w, h, d) boxes (what
    ``data/unified_pipeline.match_gt_to_pred`` and the grounding
    evaluators use)."""
    lo_a, hi_a = box_a[:3] - box_a[3:] / 2, box_a[:3] + box_a[3:] / 2
    lo_b, hi_b = box_b[:3] - box_b[3:] / 2, box_b[:3] + box_b[3:] / 2
    inter = np.prod(np.maximum(np.minimum(hi_a, hi_b)
                               - np.maximum(lo_a, lo_b), 0))
    va = np.prod(box_a[3:])
    vb = np.prod(box_b[3:])
    return float(inter / max(va + vb - inter, 1e-9))


def corners_to_aabb(corners: np.ndarray) -> np.ndarray:
    """(8, 3) corners -> (cx,cy,cz,w,h,d)."""
    lo, hi = corners.min(0), corners.max(0)
    return np.concatenate([(lo + hi) / 2, hi - lo])


def points_to_aabb(points: np.ndarray) -> np.ndarray:
    """(N, 3) points -> their (cx,cy,cz,w,h,d) box."""
    lo, hi = points.min(0), points.max(0)
    return np.concatenate([(lo + hi) / 2, hi - lo])
