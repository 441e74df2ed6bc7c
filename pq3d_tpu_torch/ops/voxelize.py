"""Host-side voxelization (numpy); copy of ``pq3d_tpu/ops/voxelize.py``.

Replaces ``ME.utils.sparse_quantize``.  Runs in the input pipeline so that
device code only ever sees fixed-shape arrays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def ravel_hash(coords: np.ndarray) -> np.ndarray:
    """Bijective hash of non-negative integer coordinates (row-major ravel)."""
    assert coords.ndim == 2
    coords = coords - coords.min(axis=0)
    coords = coords.astype(np.uint64, copy=False)
    dims = coords.max(axis=0).astype(np.uint64) + 1
    keys = np.zeros(len(coords), dtype=np.uint64)
    for d in range(coords.shape[1] - 1):
        keys += coords[:, d]
        keys *= dims[d + 1]
    keys += coords[:, -1]
    return keys


def fnv_hash(coords: np.ndarray) -> np.ndarray:
    """FNV64-1A hash over integer coordinate rows (may collide, fast)."""
    assert coords.ndim == 2
    coords = coords.copy().astype(np.uint64)
    h = np.uint64(14695981039346656037) * np.ones(len(coords), dtype=np.uint64)
    for d in range(coords.shape[1]):
        h *= np.uint64(1099511628211)
        h ^= coords[:, d]
    return h


def quantize(points: np.ndarray, voxel_size: float
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize float points to integer voxel coords, deduplicating.

    Returns ``(voxel_coords, unique_index, inverse)`` where
    ``voxel_coords[inverse[i]]`` is the voxel of point ``i`` and
    ``points[unique_index]`` are representative points (first occurrence).
    Voxels come out ravel-key sorted with z fastest, which the z-run conv
    plan (ops/zrun_conv.py) relies on.
    """
    grid = np.floor(points / voxel_size).astype(np.int32)
    keys = ravel_hash(grid)
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    first = np.ones(len(keys), dtype=bool)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    unique_index = order[first]
    group_id = np.cumsum(first) - 1
    inverse = np.empty(len(keys), dtype=np.int64)
    inverse[order] = group_id
    return grid[unique_index], unique_index, inverse


def voxel_downsample_random(points: np.ndarray, voxel_size: float,
                            rng: np.random.Generator) -> np.ndarray:
    """Pick one random point per voxel: the indices of the picked points,
    in voxel-key order."""
    grid = np.floor(points / voxel_size).astype(np.int32)
    keys = ravel_hash(grid)
    noise = rng.random(len(keys))
    order = np.lexsort((noise, keys))
    sorted_keys = keys[order]
    first = np.ones(len(keys), dtype=bool)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return order[first]
