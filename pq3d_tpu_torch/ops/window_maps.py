"""Dense window packing of sparse voxels (numpy); copy of
``pq3d_tpu/ops/window_maps.py``.

Voxels are packed into dense ``window^3`` cell grids, one per occupied
window (empty cells -1), with static padded shapes:

  cell_to_vox  (n_win_pad * w3,) int32   voxel id in each cell, -1 empty
  vox_slot     (n_vox,)          int32   flat cell of each voxel

Two users: the dense-block stem conv (ops/sparse.conv0_dense_block) packs
level-0 voxels into ``block^3`` blocks with the 27 neighbouring blocks'
ids (its halo exchange), and the Swin3D backbone (models/swin3d) attends
within the windows of hierarchy levels 1-4 in two partitions, the second
with the grid origin shifted by ``window // 2`` (a sparse partition needs
no cyclic shift).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

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


def pad_pack(pack: Dict[str, np.ndarray], window: int, n_win_pad: int,
             n_vox_pad: int) -> Dict[str, np.ndarray]:
    """Pad a window pack to static (n_win_pad, n_vox_pad) shapes: extra
    windows are empty (-1 cells), extra voxel rows get slot -1."""
    w3 = window ** 3
    if pack["n_win"] > n_win_pad:
        raise ValueError(f"{pack['n_win']} windows > pad {n_win_pad}")
    c2v = np.full(n_win_pad * w3, -1, np.int32)
    c2v[:len(pack["cell_to_vox"])] = pack["cell_to_vox"]
    slot = np.full(n_vox_pad, -1, np.int32)
    slot[:len(pack["vox_slot"])] = pack["vox_slot"]
    return {"cell_to_vox": c2v, "vox_slot": slot}


def relative_position_index(window: int) -> np.ndarray:
    """(w3, w3) int32 index of each (query cell, key cell) pair's offset
    into a (2*window-1)^3 relative-bias table."""
    r = np.arange(window)
    grid = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    rel = grid[None, :, :] - grid[:, None, :] + window - 1  # [0, 2w-2]
    d = 2 * window - 1
    return ((rel[..., 0] * d + rel[..., 1]) * d + rel[..., 2]).astype(
        np.int32)


def build_swin_packs(level_coords: List[np.ndarray], window: int,
                     levels: Sequence[int]) -> Dict[str, np.ndarray]:
    """The regular (shift 0) and shifted (shift ``window // 2``) packs of
    each attention level, from the UNPADDED coords of every hierarchy
    level: ``win{l}s{j}_c2v``, ``win{l}s{j}_slot`` (unpadded; the collate
    pads them) and ``win{l}s{j}_nwin``."""
    out: Dict[str, np.ndarray] = {}
    for l in levels:
        for j, shift in enumerate((0, window // 2)):
            p = build_window_pack(level_coords[l], window, shift)
            out[f"win{l}s{j}_c2v"] = p["cell_to_vox"]
            out[f"win{l}s{j}_slot"] = p["vox_slot"]
            out[f"win{l}s{j}_nwin"] = p["n_win"]
    return out
