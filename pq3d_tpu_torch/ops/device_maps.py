"""Kernel maps built on the device from the voxel coordinates alone.

Counterpart of ``pq3d_tpu/ops/device_maps.py``.  The host ships each
scene's biased voxel coordinates (``bias_coords_16``) and its voxel count
instead of 60-100 MB of int32 maps, and the model's forward builds the
hierarchy, the stem's maps (the dense-block stem pack, or the gather
stem's 125-tap ``nbr5_0``) and, optionally, the z-run plans on the
caller's device, in the (B, ...) shapes that
``data/instseg_pipeline.collate`` ships:

* voxel keys: coordinates are ravel-key sorted (``ops/voxelize``), so a
  linear packing with per-scene field bounds gives sorted keys per scene;
  pad rows carry ``PAD_KEY`` and sort last;
* stride-1 neighbor maps: 27 (the stem's: k^3) offset queries answered
  by a batched
  ``torch.searchsorted`` over the (B, N) sorted keys and an equality
  check; a query from a pad row, or one that lands on a pad, is -1;
* stride-2 downsampling: parent keys of row-major child keys are not
  sorted, so each coarse level sorts them (a stable sort), dedups by a
  shifted compare and numbers the groups in ascending key order, which is
  the order the host's ``downsample_coords`` gives;
* child, parent and ancestor maps and the packs by index scatters; rows
  past a level's static cap go to a trash slot past the end (the JAX
  package's ``mode="drop"``) and are cut off.

The maps equal the host's ``kernel_maps.build_hierarchy`` (and
``window_maps.build_window_pack``) exactly for coordinates biased to a
non-negative, 16-aligned origin whose counts fit the caps.  A scene that
outgrows a cap keeps parent and ancestor indices past it, which index the
next scene's rows once the batch is flattened, so the caller checks the
counts first: ``data/instseg_pipeline.collate`` refuses such a scene
(``device_map_counts``).  Keys are
int64 here (int32 in the JAX package, whose callers keep the field volume
under 2^31; every key that fits there orders the same here).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pq3d_tpu_torch.ops import kernel_maps, window_maps, zrun_conv

PAD_KEY = torch.iinfo(torch.int64).max
# hierarchy levels whose z-run plans are built (instseg_pipeline's
# ZTRIPLE_LEVELS)
ZTRIPLE_LEVELS = (1, 2, 3)


def _pack(coords: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor
          ) -> torch.Tensor:
    """Lexicographic int64 key of non-negative (B, ..., 3) coords with
    per-scene strict bounds ``dy``, ``dz`` (B,) that include a margin, so
    a +-1 offset never carries between fields."""
    shape = (-1,) + (1,) * (coords.dim() - 2)
    return ((coords[..., 0] * dy.view(shape) + coords[..., 1])
            * dz.view(shape) + coords[..., 2])


def _level_keys(coords: torch.Tensor, valid: torch.Tensor,
                dy: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, _pack(coords, dy, dz), PAD_KEY)


def _neighbor_map(coords: torch.Tensor, keys: torch.Tensor,
                  valid: torch.Tensor, n: torch.Tensor, offsets: np.ndarray,
                  dy: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """(B, N_cap, K) int32 neighbor indices of (B, N_cap, 3) coords over
    their own (B, N_cap) sorted keys; -1 missing, rows >= n all -1."""
    b, cap, _ = coords.shape
    off = torch.as_tensor(offsets, dtype=coords.dtype, device=coords.device)
    q = _pack(coords[:, :, None, :] + off, dy, dz).reshape(b, -1)
    idx = torch.searchsorted(keys, q).clamp_max(cap - 1)
    hit = ((keys.gather(1, idx) == q) & (idx < n[:, None])).view(
        b, cap, -1) & valid[:, :, None]
    return torch.where(hit, idx.view(b, cap, -1), -1).int()


def _group(keys: torch.Tensor):
    """Sort (B, N) keys (stable) and number the distinct non-pad keys in
    ascending order: (order, valid_s, first_s, rank_s, count), with
    ``valid_s`` the sorted positions that hold a key, ``first_s`` those
    that open a group and ``rank_s`` their group id."""
    sk, order = torch.sort(keys, dim=1, stable=True)
    valid_s = sk != PAD_KEY
    first_s = valid_s & torch.cat(
        [torch.ones_like(valid_s[:, :1]), sk[:, 1:] != sk[:, :-1]], 1)
    rank_s = first_s.long().cumsum(1) - 1
    return order, valid_s, first_s, rank_s, first_s.sum(1)


def _compact(values: torch.Tensor, order: torch.Tensor,
             first_s: torch.Tensor, rank_s: torch.Tensor, cap: int
             ) -> torch.Tensor:
    """(B, cap, 3): the first row of each group in ascending key order;
    groups past ``cap`` land in a trash row that is cut off."""
    b = values.shape[0]
    tgt = torch.where(first_s & (rank_s < cap), rank_s, cap)
    out = values.new_zeros(b, cap + 1, 3)
    out.scatter_(1, tgt[:, :, None].expand(-1, -1, 3),
                 values.gather(1, order[:, :, None].expand(-1, -1, 3)))
    return out[:, :cap]


def build_device_hierarchy(coords0: torch.Tensor, n0: torch.Tensor,
                           level_caps: Sequence[int],
                           conv0_kernel: int = 5, build_nbr5: bool = False,
                           num_levels: int = kernel_maps.NUM_LEVELS
                           ) -> Dict[str, torch.Tensor]:
    """Device twin of ``kernel_maps.build_hierarchy`` for a batch.

    Args:
      coords0: (B, cap0, 3) int coords, ravel-key sorted per scene,
        non-negative with a 16-aligned origin; pad rows arbitrary.
      n0: (B,) true voxel counts.
      level_caps: static per-level pads (level_caps[0] == cap0).
      conv0_kernel, build_nbr5: with ``build_nbr5``, also the gather
        stem's map ``nbr5_0`` (B, cap0, conv0_kernel^3).

    Returns the per-level arrays the host pipeline ships, in its dtypes:
    ``valid_l`` (B, cap_l), ``nbr3_l`` (B, cap_l, 27), ``child_l`` (B,
    cap_{l+1}, 8), ``parent_l`` / ``parent_off_l`` (B, cap_l),
    ``ancestor`` (B, num_levels, cap0), ``nbr5_0`` when asked; and
    ``coords_l`` (B, cap_l, 3), ``n_l`` (B,).  The field bounds' margin of
    3 holds the 5^3 offsets too: an offset past a scene's low edge packs
    to a negative key or one whose coordinate passes the scene's largest,
    where no voxel lies.
    """
    b, cap0, _ = coords0.shape
    if cap0 != level_caps[0] or len(level_caps) < num_levels:
        raise ValueError(f"coords of {cap0} rows do not fit level caps "
                         f"{tuple(level_caps)}")
    dev = coords0.device
    off3 = kernel_maps.kernel_offsets(3)
    out: Dict[str, torch.Tensor] = {}
    coords = coords0.long()
    n = n0.long()
    rows0 = torch.arange(cap0, device=dev)
    valid = rows0 < n[:, None]
    # field bounds from the finest level (+3: the +-1 offsets and a spare);
    # coarser levels shrink, so one bound serves every level
    cmax = torch.where(valid[:, :, None], coords, 0).amax(1)
    dy, dz = cmax[:, 1] + 3, cmax[:, 2] + 3
    ancestor = [rows0.expand(b, cap0)]
    for lvl in range(num_levels):
        cap = level_caps[lvl]
        rows = torch.arange(cap, device=dev)
        keys = _level_keys(coords, valid, dy, dz)
        out[f"coords_{lvl}"] = torch.where(valid[:, :, None], coords,
                                           0).int()
        out[f"valid_{lvl}"] = valid
        out[f"n_{lvl}"] = n.int()
        out[f"nbr3_{lvl}"] = _neighbor_map(coords, keys, valid, n, off3,
                                           dy, dz)
        if lvl == 0 and build_nbr5:
            out["nbr5_0"] = _neighbor_map(
                coords, keys, valid, n,
                kernel_maps.kernel_offsets(conv0_kernel), dy, dz)
        if lvl == num_levels - 1:
            break
        cap_next = level_caps[lvl + 1]
        coarse_all = coords >> 1
        order, valid_s, first_s, rank_s, n_next = _group(
            _level_keys(coarse_all, valid, dy, dz))
        parent = torch.empty_like(order).scatter_(
            1, order, torch.where(valid_s, rank_s, -1))
        lsb = coords & 1
        poff = lsb[..., 0] * 4 + lsb[..., 1] * 2 + lsb[..., 2]
        out[f"parent_{lvl}"] = parent.int()
        out[f"parent_off_{lvl}"] = torch.where(valid, poff, 0).int()
        fits = valid & (parent >= 0) & (parent < cap_next)
        child = torch.full((b, cap_next * 8 + 1), -1, dtype=torch.long,
                           device=dev)
        child.scatter_(1, torch.where(fits, parent * 8 + poff, cap_next * 8),
                       rows.expand(b, cap))
        out[f"child_{lvl}"] = child[:, :cap_next * 8].reshape(
            b, cap_next, 8).int()
        prev = ancestor[-1]
        ancestor.append(torch.where(prev >= 0,
                                    parent.gather(1, prev.clamp_min(0)), -1))
        coords = _compact(coarse_all, order, first_s, rank_s, cap_next)
        n = n_next.clamp_max(cap_next)
        valid = torch.arange(cap_next, device=dev) < n[:, None]
    # pad rows are 0 at every level, as in the host's ancestor table
    valid0 = rows0 < n0.long()[:, None]
    out["ancestor"] = torch.where(valid0[:, None, :],
                                  torch.stack(ancestor, 1), 0).int()
    return out


def bias_coords_16(coords: np.ndarray, align: int = 16
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: shift coords to a non-negative, ``align``-aligned
    origin.  ``floor(c / 2^l) - base / 2^l == floor((c - base) / 2^l)``
    when ``base`` is a multiple of ``2^l``, so 16-alignment keeps every
    stride-2 grouping (4 levels) and the 8^3 stem blocking of the host
    build on the original coords: every index array is unchanged.  Swin
    window packs at level ``l`` also need ``base`` divisible by ``window *
    2^l`` (see ``swin_bias_align``).  Returns ``(biased int32, base
    int64)``."""
    base = np.floor_divide(coords.min(0).astype(np.int64), align) * align
    return (coords.astype(np.int64) - base).astype(np.int32), base


def swin_bias_align(swin_window: int, max_level: int = 4) -> int:
    """The bias alignment that keeps the hierarchy and the swin window
    grouping of every level up to ``max_level`` intact: ``window <<
    max_level`` (64 at window 4), at least 16."""
    return max(16, int(swin_window) << max_level) if swin_window else 16


def build_device_stem_pack(coords0: torch.Tensor, n0: torch.Tensor,
                           nb_cap: int, block: int = 8
                           ) -> Dict[str, torch.Tensor]:
    """Device twin of ``window_maps.build_window_pack`` (shift 0, with
    neighbors) for the dense-block stem, batched: level-0 voxels packed
    into dense ``block^3`` blocks numbered in ascending block-key order.

    Returns ``vox_slot`` (B, cap0) (-1 pad or overflow), ``cell_to_vox``
    (B, nb_cap * block^3), ``nbr_win`` (B, nb_cap, 27), ``n_win`` (B,),
    int32, equal to the host pack within its true region."""
    if block & (block - 1):
        raise ValueError(f"stem block {block} is not a power of two")
    shift = block.bit_length() - 1
    b3 = block ** 3
    b, cap0, _ = coords0.shape
    dev = coords0.device
    c = coords0.long()
    rows = torch.arange(cap0, device=dev)
    valid = rows < n0.long()[:, None]
    bc = c >> shift
    bmax = torch.where(valid[:, :, None], bc, 0).amax(1)
    dy, dz = bmax[:, 1] + 3, bmax[:, 2] + 3
    order, valid_s, first_s, rank_s, n_win = _group(
        _level_keys(bc, valid, dy, dz))
    win_of = torch.empty_like(order).scatter_(
        1, order, torch.where(valid_s, rank_s, -1))
    local = c & (block - 1)
    cell = (local[..., 0] * block + local[..., 1]) * block + local[..., 2]
    ok = valid & (win_of >= 0) & (win_of < nb_cap)
    vox_slot = torch.where(ok, win_of * b3 + cell, -1)
    c2v = torch.full((b, nb_cap * b3 + 1), -1, dtype=torch.long, device=dev)
    c2v.scatter_(1, torch.where(ok, vox_slot, nb_cap * b3),
                 rows.expand(b, cap0))
    wb = _compact(bc, order, first_s, rank_s, nb_cap)
    nw = n_win.clamp_max(nb_cap)
    valid_win = torch.arange(nb_cap, device=dev) < nw[:, None]
    nbr_win = _neighbor_map(wb, _level_keys(wb, valid_win, dy, dz),
                            valid_win, nw, kernel_maps.kernel_offsets(3),
                            dy, dz)
    return {"vox_slot": vox_slot.int(), "cell_to_vox": c2v[:, :-1].int(),
            "nbr_win": nbr_win, "n_win": n_win.int()}


def stem_cap(level_caps: Sequence[int]) -> int:
    """The device stem pack's static block cap: the host pipeline's
    ``stem_pad_blocks`` default, ``bucket(level_caps[0] // 16)``, which the
    host's overflow count under ``device_maps`` uses."""
    return window_maps.bucket(int(level_caps[0]) // 16)


def build_batch_maps(vox_coords: torch.Tensor, n_voxels: torch.Tensor,
                     voxel_feats: Optional[torch.Tensor],
                     level_caps: Sequence[int],
                     conv0_kernel: int = 5,
                     stem_mode: str = "dense_block",
                     stem_block: int = 8,
                     ztriple: bool = False) -> Dict[str, torch.Tensor]:
    """The ``maps`` dict of ``instseg_pipeline.collate`` built on the
    device from the biased voxel coords (B, cap0, 3) and true counts (B,):
    hierarchy levels, the stem's maps of ``stem_mode`` ('dense_block': the
    stem pack of ``stem_cap(level_caps)`` blocks, with the
    packed ``stem_dense`` blocks when ``voxel_feats`` (B, cap0, Cin) is
    given; 'gather': ``nbr5_0`` at ``conv0_kernel``) and, with
    ``ztriple``, the z-run plans of levels 1-3 from
    ``zrun_conv.zrun_plan`` (the JAX package's ``device_zrun_plan``)."""
    caps = tuple(int(c) for c in level_caps)
    maps = build_device_hierarchy(vox_coords, n_voxels, caps,
                                  conv0_kernel=conv0_kernel,
                                  build_nbr5=stem_mode == "gather")
    if stem_mode == "dense_block":
        maps.update(_stem_maps(vox_coords, n_voxels, voxel_feats,
                               stem_cap(caps), stem_block))
    if ztriple:
        for l in ZTRIPLE_LEVELS:
            maps[f"zt{l}_base"], maps[f"zt{l}_code"] = zrun_conv.zrun_plan(
                maps[f"nbr3_{l}"])
    return maps


def _stem_maps(vox_coords: torch.Tensor, n_voxels: torch.Tensor,
               voxel_feats: Optional[torch.Tensor], nb_cap: int,
               stem_block: int) -> Dict[str, torch.Tensor]:
    """The dense-block stem pack's maps (and packed features) for
    ``build_batch_maps``."""
    maps: Dict[str, torch.Tensor] = {}
    b3 = stem_block ** 3
    pack = build_device_stem_pack(vox_coords, n_voxels, nb_cap, stem_block)
    maps["stem_nbrblk"] = pack["nbr_win"]
    maps["stem_slot"] = pack["vox_slot"]
    maps["stem_c2v"] = pack["cell_to_vox"]
    maps["stem_n_win"] = pack["n_win"]
    if voxel_feats is not None:
        b, cap0, cin = voxel_feats.shape
        slot = pack["vox_slot"].long()
        tgt = torch.where(slot >= 0, slot, nb_cap * b3)
        dense = voxel_feats.new_zeros(b, nb_cap * b3 + 1, cin)
        dense.scatter_(1, tgt[:, :, None].expand(-1, -1, cin), voxel_feats)
        maps["stem_dense"] = dense[:, :-1].reshape(b, nb_cap, b3 * cin)
    return maps


def hierarchy_to_host_format(dev: Dict[str, torch.Tensor],
                             num_levels: int = 5) -> Dict[str, np.ndarray]:
    """The device-built maps as numpy arrays (a test and debug helper)."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in dev.items()}
