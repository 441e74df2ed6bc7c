"""Host-side furthest point sampling (numpy); copy of ``fps_numpy`` from
``pq3d_tpu/ops/sampling.py``, the only sampling op the serving pipeline
uses (query initialization)."""
from __future__ import annotations

import numpy as np

from pq3d_tpu_torch.ops._native import lib


def fps_numpy(points: np.ndarray, npoint: int, start: int = 0,
              subsample: int = 0,
              rng: np.random.Generator | None = None) -> np.ndarray:
    """Greedy FPS from ``start``: (N, 3) -> (npoint,) int64 indices.

    ``subsample`` > 0 runs FPS on a random candidate subset (indices still
    refer to the full array), the same accuracy/speed trade the reference's
    bucket FPS makes."""
    n = len(points)
    if n == 0:
        return np.zeros(npoint, dtype=np.int64)
    if subsample and n > subsample >= npoint:
        rng = rng or np.random.default_rng(0)
        cand = rng.choice(n, size=subsample, replace=False)
        return cand[fps_numpy(points[cand], npoint, start)]
    # both paths compute in f32 so picks are identical whether or not the
    # native library compiled
    points = np.asarray(points, np.float32)
    if points.ndim == 2 and points.shape[1] == 3:
        L = lib()
        if L is not None:
            pts = np.ascontiguousarray(points)
            picks = np.empty(npoint, dtype=np.int64)
            L.pq3d_fps(pts.ctypes.data, n, npoint, start % n,
                       picks.ctypes.data)
            return picks
    picks = np.empty(npoint, dtype=np.int64)
    mind = np.full(n, np.inf, np.float32)
    last = start % n
    for i in range(npoint):
        picks[i] = last
        d = np.sum((points - points[last]) ** 2, axis=-1)
        np.minimum(mind, d, out=mind)
        last = int(np.argmax(mind))
    return picks
