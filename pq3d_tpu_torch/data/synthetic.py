"""Synthetic 3D scenes for tests, smoke runs and benchmarks; copy of
``pq3d_tpu/data/synthetic.py``.

Generates rooms of box instances over a floor with per-point instance ids
and an over-segmentation, structurally matching SceneVerse scan dicts.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def make_scene(rng: np.random.Generator, n_points: int = 20000,
               n_instances: int = 8, n_segments: int = 64,
               extent: float = 5.0) -> Dict[str, np.ndarray]:
    """Returns a scan dict: points (N,3), colors (N,3) in [-1,1],
    instance_labels (N,), segment_id (N,), inst_labels (n_inst,) class ids."""
    pts = []
    inst = []
    n_floor = n_points // 4
    floor = np.zeros((n_floor, 3), np.float32)
    floor[:, 0] = rng.random(n_floor) * extent
    floor[:, 1] = rng.random(n_floor) * extent
    floor[:, 2] = rng.random(n_floor) * 0.05
    pts.append(floor)
    inst.append(np.full(n_floor, -1))

    per_obj = (n_points - n_floor) // n_instances
    for i in range(n_instances):
        center = rng.random(3) * np.array([extent, extent, 1.5]) + \
            np.array([0, 0, 0.2])
        size = rng.random(3) * 0.6 + 0.2
        # points on a box surface
        p = (rng.random((per_obj, 3)) - 0.5) * size
        face = rng.integers(0, 3, per_obj)
        sign = rng.choice([-0.5, 0.5], per_obj)
        p[np.arange(per_obj), face] = sign * size[face]
        pts.append((center + p).astype(np.float32))
        inst.append(np.full(per_obj, i))

    points = np.concatenate(pts)
    instance_labels = np.concatenate(inst)
    n = len(points)
    colors = (rng.random((n, 3)) * 2 - 1).astype(np.float32)

    # over-segmentation: spatial grid cells, split per instance
    cell = extent / max(2, int(np.sqrt(n_segments)))
    seg_key = np.floor(points[:, :2] / cell).astype(np.int64)
    seg_key = seg_key[:, 0] * 1000 + seg_key[:, 1]
    seg_key = seg_key + (instance_labels + 1) * 1000000
    _, segment_id = np.unique(seg_key, return_inverse=True)

    inst_labels = rng.integers(3, 50, n_instances)  # class ids, avoid 0/2
    return {
        "points": points,
        "colors": colors,
        "instance_labels": instance_labels.astype(np.int64),
        "segment_id": segment_id.astype(np.int64),
        "inst_labels": inst_labels.astype(np.int64),
    }
