"""Dense-block packing of sparse voxels (numpy); copy of the stem-pack part
of ``pq3d_tpu/ops/window_maps.py``.

The dense-block stem conv (ops/sparse.conv0_dense_block) packs level-0
voxels into dense ``block^3`` cells per occupied block and exchanges halos
between the 27 neighbouring blocks, so the 5^3 stem runs as a dense conv.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from pq3d_tpu_torch.ops.kernel_maps import kernel_offsets


def build_window_pack(coords: np.ndarray, window: int, shift: int = 0,
                      with_neighbors: bool = False) -> Dict[str, np.ndarray]:
    """Partition voxel ``coords`` ((N, 3) int, any sign) into dense
    ``window^3`` blocks whose grid origin is shifted by ``-shift``.

    Returns ``cell_to_vox`` (n_win * window^3,) voxel id per cell (-1
    empty), ``vox_slot`` (N,) flat cell per voxel and ``n_win``; with
    ``with_neighbors`` also ``nbr_win`` (n_win, 27): the block id at each of
    the 27 spatial offsets (kernel_offsets(3) order, -1 = none).
    """
    w3 = window ** 3
    n = len(coords)
    if n == 0:
        out = {"cell_to_vox": np.full((0,), -1, np.int32),
               "vox_slot": np.zeros((0,), np.int32), "n_win": 0}
        if with_neighbors:
            out["nbr_win"] = np.zeros((0, 27), np.int32)
        return out
    sh = coords.astype(np.int64) + shift
    wc = sh // window                 # floor division: correct for negatives
    local = sh - wc * window          # in [0, window) even for negative sh
    # shift the block grid to its own origin so the ravel key is injective
    wc = wc - wc.min(0)
    dims = wc.max(0) + 1
    key = (wc[:, 0] * dims[1] + wc[:, 1]) * dims[2] + wc[:, 2]
    ukeys, inv = np.unique(key, return_inverse=True)
    n_win = len(ukeys)
    cell = (local[:, 0] * window + local[:, 1]) * window + local[:, 2]
    slot = (inv * w3 + cell).astype(np.int32)
    cell_to_vox = np.full(n_win * w3, -1, np.int32)
    cell_to_vox[slot] = np.arange(n, dtype=np.int32)
    out = {"cell_to_vox": cell_to_vox, "vox_slot": slot, "n_win": n_win}
    if with_neighbors:
        ub = np.stack([ukeys // (dims[1] * dims[2]),
                       (ukeys // dims[2]) % dims[1],
                       ukeys % dims[2]], axis=1)
        offs = kernel_offsets(3)
        nbr = np.full((n_win, 27), -1, np.int32)
        for t, o in enumerate(offs):
            q = ub + o[None, :]
            inside = ((q >= 0) & (q < dims[None, :])).all(1)
            qk = (q[:, 0] * dims[1] + q[:, 1]) * dims[2] + q[:, 2]
            pos = np.searchsorted(ukeys, qk)
            pos_c = np.minimum(pos, n_win - 1)
            hit = (ukeys[pos_c] == qk) & inside
            nbr[:, t] = np.where(hit, pos_c, -1)
        out["nbr_win"] = nbr
    return out


def bucket(n: int, step: int = 256) -> int:
    return max(step, int(np.ceil(n / step)) * step)
