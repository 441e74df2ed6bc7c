"""Flat-layout kernel maps built on the device from the voxel coordinates
alone; counterpart of ``pq3d_tpu/ops/device_flat_maps.py``.

``build_flat_maps`` builds the maps dict of
``data/instseg_pipeline.collate_flat`` on the tensors' device from the
concatenated biased voxel coords (``tot_0`` x 3) and the per-scene voxel
counts (B,).  The flat layout is scene-major and each scene's coords are
ravel-key sorted (``ops/voxelize``), so the scene-augmented key
``scene * vol + pack(coords)`` (int64, ``vol`` the level-0 field volume
with a +3 margin per axis) sorts the whole flat vector.  Then:

* stride-1 neighbor maps: one ``torch.searchsorted`` per offset of the
  first half of the 3^3 stencil over the flat keys, which gives flat row
  indices directly; the mirrored offset's column is a scatter of the same
  hits (a hit ``i -> j`` at offset t is the hit ``j -> i`` at 26 - t);
* stride-2 downsampling and window packs: one stable sort and dedup of
  the flat vector; ascending (scene, key) group numbers are the host's
  per-scene ascending ranks plus the scene's start;
* the shift-0 swin packs at window 4 come from the hierarchy: grouping by
  ``c >> 2`` is level l+2, so a voxel's window rank is its two-step
  parent, and the chain is extended by two virtual levels for levels 3-4;
* rows past a static cap go to a trash slot past the end of a buffer of
  ``n + 1`` that is then cut off (the JAX package's ``mode="drop"``).

Every output shape is static, from ``caps`` (the serving shape lock, the
keys ``collate_flat`` records in ``_meta['flat_dims']``), and nothing
reads a value back to the host.  The maps equal ``collate_flat``'s bit
for bit for coords biased by ``device_maps.bias_coords_16`` at
``device_maps.swin_bias_align``'s alignment whose counts fit the caps.

Keys are int64 here and uint32 in the JAX package, where a query off a
scene's low edge wraps above every valid key.  Here such a query lands in
the previous scene's +3 margin (or below 0 for scene 0), where no valid
key lies, so it never hits either.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from pq3d_tpu_torch.ops import kernel_maps, zrun_conv
from pq3d_tpu_torch.ops.device_maps import PAD_KEY, ZTRIPLE_LEVELS


def _aug_key(coords: torch.Tensor, scene: torch.Tensor, valid: torch.Tensor,
             dims: torch.Tensor) -> torch.Tensor:
    """Scene-augmented int64 key of (N, 3) coords with per-axis strict
    bounds ``dims`` (3,) that include the margin; PAD_KEY where not
    ``valid``."""
    c = coords.long()
    base = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
    k = base + scene.long() * (dims[0] * dims[1] * dims[2])
    return torch.where(valid, k, PAD_KEY)


def _drop_set(n: int, idx: torch.Tensor, values: torch.Tensor,
              fill: int = -1) -> torch.Tensor:
    """(n,) ``fill`` with ``values`` written at ``idx``; an index of ``n``
    goes to a trash slot that is cut off."""
    out = torch.full((n + 1,), fill, dtype=values.dtype,
                     device=values.device)
    out.scatter_(0, idx.long(), values)
    return out[:n]


def _nbr_map(coords: torch.Tensor, scene: torch.Tensor, keys: torch.Tensor,
             valid: torch.Tensor, total: torch.Tensor, offsets: np.ndarray,
             dims: torch.Tensor) -> torch.Tensor:
    """(N, K) int32 flat neighbor indices, -1 missing; pad rows all -1.
    Probes the first half of a symmetric stencil and scatters its hits
    into the mirrored columns."""
    n = keys.shape[0]
    k = len(offsets)
    offsets = np.asarray(offsets)
    sym = k % 2 == 1 and bool((offsets == -offsets[::-1]).all())
    rows = torch.arange(n, dtype=torch.int32, device=keys.device)
    cols: list = [None] * k
    for t, off in enumerate(offsets):
        if sym and t > k // 2:
            break
        if sym and t == k // 2:              # the centre: identity
            cols[t] = torch.where(valid, rows, -1)
            continue
        q = _aug_key(coords + torch.as_tensor(off, dtype=coords.dtype,
                                              device=coords.device),
                     scene, valid, dims)
        idx = torch.searchsorted(keys, q).clamp_max(n - 1)
        hit = (keys[idx] == q) & (idx < total) & valid
        idx = idx.int()
        cols[t] = torch.where(hit, idx, -1)
        if sym:
            cols[k - 1 - t] = _drop_set(n, torch.where(hit, idx, n), rows)
    return torch.stack(cols, 1)


def _group_by_key(keys: torch.Tensor, scene: torch.Tensor, n_scenes: int):
    """Stable sort and dedup of scene-augmented ``keys`` (pads sort last):
    ``(order, first_s, rank_s, rank, counts, total)`` with ``rank`` the
    global group id of each row (original order, -1 for pads), ``counts``
    the groups per scene and ``total`` their sum."""
    n = keys.shape[0]
    sk, order = torch.sort(keys, stable=True)
    valid_s = sk != PAD_KEY
    first_s = valid_s & torch.cat(
        [torch.ones_like(valid_s[:1]), sk[1:] != sk[:-1]])
    rank_s = (first_s.int().cumsum(0) - 1).int()
    total = first_s.sum().int()
    rank = torch.empty(n, dtype=torch.int32, device=keys.device).scatter_(
        0, order, torch.where(valid_s, rank_s, -1))
    scene_s = torch.where(valid_s, scene[order].long(), n_scenes)
    counts = torch.zeros(n_scenes + 1, dtype=torch.int32,
                         device=keys.device).scatter_add_(
        0, scene_s, first_s.int())[:n_scenes]
    return order, first_s, rank_s, rank, counts, total


def _compact(values: torch.Tensor, order: torch.Tensor,
             first_s: torch.Tensor, rank_s: torch.Tensor, cap: int
             ) -> torch.Tensor:
    """(cap, 3): the first row of each group in ascending key order;
    groups past ``cap`` go to a trash row that is cut off."""
    tgt = torch.where(first_s & (rank_s < cap), rank_s, cap).long()
    out = values.new_zeros(cap + 1, 3)
    out.scatter_(0, tgt[:, None].expand(-1, 3), values[order])
    return out[:cap]


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.new_zeros(1), x.cumsum(0)[:-1]]).to(x.dtype)


def _scene_of(starts: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The scene of each flat row: how many scene starts are <= it, - 1."""
    return (torch.searchsorted(starts.int(), rows, right=True) - 1).int()


def _rect_gather(starts: torch.Tensor, counts: torch.Tensor, cap: int
                 ) -> torch.Tensor:
    """(B, cap) flat row of each scene-local rank, -1 past the count."""
    r = torch.arange(cap, dtype=torch.int32, device=starts.device)[None, :]
    return torch.where(r < counts[:, None], starts[:, None].int() + r, -1)


def _window_pack(coords: torch.Tensor, scene: torch.Tensor,
                 valid: torch.Tensor, n_scenes: int, window: int, shift: int,
                 nw_cap: int, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Flat twin of ``window_maps.build_window_pack`` plus ``collate_flat``'s
    concatenation: windows numbered globally, scene-major, ascending key.
    Returns ``c2v`` (nw_cap * w3,), ``slot`` (N,) (-1 pads and overflow)
    and the compacted window coords, scenes, count and bounds (for the
    stem's block neighbor map)."""
    if window & (window - 1):
        raise ValueError(f"window {window} is not a power of two")
    lw = window.bit_length() - 1
    w3 = window ** 3
    sh = coords + shift
    wc = sh >> lw
    dims = torch.where(valid[:, None], wc, 0).amax(0).long() + 3
    keys = _aug_key(wc, scene, valid, dims)
    order, first_s, rank_s, rank, counts, total = _group_by_key(
        keys, scene, n_scenes)
    local = sh & (window - 1)
    cell = ((local[:, 0] * window + local[:, 1]) * window
            + local[:, 2]).int()
    ok = valid & (rank >= 0) & (rank < nw_cap)
    slot = torch.where(ok, rank * w3 + cell, -1)
    c2v = _drop_set(nw_cap * w3, torch.where(ok, slot, nw_cap * w3), rows)
    tgt = torch.where(first_s & (rank_s < nw_cap), rank_s, nw_cap)
    win_scene = _drop_set(nw_cap, tgt, scene[order].int(), fill=n_scenes)
    return {"c2v": c2v, "slot": slot,
            "win_coords": _compact(wc, order, first_s, rank_s, nw_cap),
            "win_scene": win_scene,
            "n_win": torch.clamp_max(total, nw_cap), "win_dims": dims}


def _chain_pack(lc: torch.Tensor, lvalid: torch.Tensor, lrows: torch.Tensor,
                p1: torch.Tensor, p2: torch.Tensor, nw_cap: int
                ) -> Dict[str, torch.Tensor]:
    """The shift-0 window-4 pack of a level read off its two-step parent
    chain ``p2[p1]`` (the level l+2 rank is the window rank); a parent rank
    past ``p2``'s rows (a cap overflow) is clamped before the read and
    counts as no window."""
    p1c = p1.clamp(0, p2.shape[0] - 1).long()
    rank = torch.where((p1 >= 0) & (p1 < p2.shape[0]), p2[p1c], -1)
    local = lc & 3
    cell = ((local[:, 0] * 4 + local[:, 1]) * 4 + local[:, 2]).int()
    ok = lvalid & (rank >= 0) & (rank < nw_cap)
    slot = torch.where(ok, rank * 64 + cell, -1)
    return {"c2v": _drop_set(nw_cap * 64, torch.where(ok, slot, nw_cap * 64),
                             lrows),
            "slot": slot}


def build_flat_maps(coords0: torch.Tensor, counts0: torch.Tensor,
                    caps: Mapping[str, int], swin_window: int = 0,
                    swin_levels: Sequence[int] = (1, 2, 3, 4),
                    stem_mode: str = "none", stem_block: int = 8,
                    voxel_feats: Optional[torch.Tensor] = None,
                    ztriple: bool = False,
                    num_levels: int = kernel_maps.NUM_LEVELS
                    ) -> Dict[str, torch.Tensor]:
    """Device twin of ``collate_flat``'s maps.

    Args:
      coords0: (caps['tot_0'], 3) int coords, each scene biased
        (``device_maps.bias_coords_16``) and ravel-key sorted, scene-major;
        rows past the true total are ignored.
      counts0: (B,) true voxel counts per scene.
      caps: the static flat dims: ``tot_l`` and ``rect_l`` of every level,
        ``win{l}s{j}_nw`` with ``swin_window``, ``stem_nb`` with
        ``stem_mode='dense_block'``.
      voxel_feats: (tot_0, C), needed by the dense-block stem pack.
      ztriple: also build the z-run plans of levels 1-3
        (``zrun_conv.zrun_plan``).

    Returns the flat maps (``valid_l``, ``nbr3_l``, ``child_l``,
    ``parent_l``, ``parent_off_l``, ``ancestor``, ``anc_local``,
    ``voxel_scene``, ``rect_l``, the swin or stem packs, the plans) in the
    host's dtypes.
    """
    tot0 = coords0.shape[0]
    if tot0 != int(caps["tot_0"]):
        raise ValueError(f"{tot0} coord rows != caps['tot_0'] "
                         f"{caps['tot_0']}")
    if stem_mode not in ("none", "dense_block"):
        raise NotImplementedError(
            f"flat device maps with stem_mode {stem_mode!r}: the port "
            "builds the 'dense_block' stem pack or none (swin3d)")
    dev = coords0.device
    b = counts0.shape[0]
    off3 = kernel_maps.kernel_offsets(3)
    out: Dict[str, torch.Tensor] = {}

    counts = counts0.int()
    starts = _excl_cumsum(counts)
    total = counts.sum().int()
    rows0 = torch.arange(tot0, dtype=torch.int32, device=dev)
    scene0 = _scene_of(starts, rows0)
    valid = rows0 < total
    scene = torch.where(valid, scene0, b)
    coords = coords0.int()
    # level-0 bounds (+3: the +-1 offsets and a spare) serve every level
    dims = torch.where(valid[:, None], coords, 0).amax(0).long() + 3

    anc = [rows0]
    parents = []          # each level's global parent ranks (then virtual)
    levels = []           # (coords, scene, valid, rows, starts) per level
    for lvl in range(num_levels):
        tot_l = int(caps[f"tot_{lvl}"])
        rows = torch.arange(tot_l, dtype=torch.int32, device=dev)
        keys = _aug_key(coords, scene, valid, dims)
        out[f"valid_{lvl}"] = valid
        out[f"nbr3_{lvl}"] = _nbr_map(coords, scene, keys, valid, total,
                                      off3, dims)
        out[f"rect_{lvl}"] = _rect_gather(starts, counts,
                                          int(caps[f"rect_{lvl}"]))
        levels.append((coords, scene, valid, rows, starts))
        if lvl == num_levels - 1:
            break
        tot_next = int(caps[f"tot_{lvl + 1}"])
        coarse_all = coords >> 1
        order, first_s, rank_s, parent, counts_n, total_n = _group_by_key(
            _aug_key(coarse_all, scene, valid, dims), scene, b)
        lsb = coords & 1
        poff = (lsb[:, 0] * 4 + lsb[:, 1] * 2 + lsb[:, 2]).int()
        out[f"parent_{lvl}"] = parent
        parents.append(parent)
        out[f"parent_off_{lvl}"] = torch.where(valid, poff, 0)
        fits = valid & (parent >= 0) & (parent < tot_next)
        out[f"child_{lvl}"] = _drop_set(
            tot_next * 8, torch.where(fits, parent * 8 + poff, tot_next * 8),
            rows).reshape(tot_next, 8)
        prev = anc[-1]
        anc.append(torch.where(prev >= 0, parent[prev.clamp_min(0).long()],
                               -1))
        coords = _compact(coarse_all, order, first_s, rank_s, tot_next)
        counts = counts_n.clamp_max(tot_next)
        starts = _excl_cumsum(counts)
        total = total_n.clamp_max(tot_next)
        rows_next = torch.arange(tot_next, dtype=torch.int32, device=dev)
        valid = rows_next < total
        scene = torch.where(valid, _scene_of(starts, rows_next), b)

    valid0 = rows0 < counts0.sum()
    ancestor = torch.where(valid0[None, :], torch.stack(anc).clamp_min(0),
                           0)
    out["ancestor"] = ancestor
    s0 = scene0.clamp_max(b - 1).long()
    out["anc_local"] = torch.where(valid0[None, :], torch.stack(
        [ancestor[lvl] - levels[lvl][4][s0] for lvl in range(num_levels)]),
        0)
    out["voxel_scene"] = torch.where(valid0, scene0, 0)

    if swin_window:
        w3 = swin_window ** 3
        if swin_window == 4:
            # two virtual levels past the last, at its cap, so that levels
            # 3 and 4 have a two-step parent chain too
            vcap = levels[-1][0].shape[0]
            vc, vs, vv = coords, scene, valid
            vrows = torch.arange(vcap, dtype=torch.int32, device=dev)
            for _ in range(max(swin_levels) + 2 - num_levels + 1):
                order, first_s, rank_s, parent, counts_n, total_n = \
                    _group_by_key(_aug_key(vc >> 1, vs, vv, dims), vs, b)
                parents.append(parent)
                vc = _compact(vc >> 1, order, first_s, rank_s, vcap)
                vv = vrows < total_n.clamp_max(vcap)
                vs = torch.where(vv, _scene_of(
                    _excl_cumsum(counts_n.clamp_max(vcap)), vrows), b)
        for lvl in swin_levels:
            lc, ls, lvalid, lrows, _ = levels[lvl]
            for j, shift in enumerate((0, swin_window // 2)):
                key = f"win{lvl}s{j}"
                nw_cap = int(caps[f"{key}_nw"])
                if j == 0 and swin_window == 4 and lvl + 1 < len(parents):
                    p = _chain_pack(lc, lvalid, lrows, parents[lvl],
                                    parents[lvl + 1], nw_cap)
                else:
                    p = _window_pack(lc, ls, lvalid, b, swin_window, shift,
                                     nw_cap, lrows)
                out[f"{key}_c2v"] = p["c2v"]
                out[f"{key}_slot"] = p["slot"]

    if stem_mode == "dense_block":
        if voxel_feats is None:
            raise ValueError("the dense-block stem pack needs voxel_feats")
        lc, ls, lvalid, lrows, _ = levels[0]
        nb = int(caps["stem_nb"])
        b3 = stem_block ** 3
        p = _window_pack(lc, ls, lvalid, b, stem_block, 0, nb, lrows)
        out["stem_c2v"] = p["c2v"]
        out["stem_slot"] = p["slot"]
        wvalid = torch.arange(nb, dtype=torch.int32, device=dev) < p["n_win"]
        out["stem_nbrblk"] = _nbr_map(
            p["win_coords"], p["win_scene"],
            _aug_key(p["win_coords"], p["win_scene"], wvalid, p["win_dims"]),
            wvalid, p["n_win"], off3, p["win_dims"])
        cin = voxel_feats.shape[1]
        tgt = torch.where(p["slot"] >= 0, p["slot"], nb * b3).long()
        dense = voxel_feats.new_zeros(nb * b3 + 1, cin)
        dense.scatter_(0, tgt[:, None].expand(-1, cin), voxel_feats)
        out["stem_dense"] = dense[:nb * b3].reshape(nb, b3 * cin)

    if ztriple:
        for lvl in ZTRIPLE_LEVELS:
            out[f"zt{lvl}_base"], out[f"zt{lvl}_code"] = zrun_conv.zrun_plan(
                out[f"nbr3_{lvl}"])
    return out


def flat_caps_complete(caps: Mapping[str, int], swin_window: int,
                       swin_levels: Sequence[int], stem_mode: str,
                       num_levels: int = kernel_maps.NUM_LEVELS) -> list:
    """The names missing from ``caps`` for this configuration (a host
    check, so that a collate or a model fails before it builds)."""
    need = [f"tot_{l}" for l in range(num_levels)]
    need += [f"rect_{l}" for l in range(num_levels)]
    if swin_window:
        need += [f"win{l}s{j}_nw" for l in swin_levels for j in (0, 1)]
    if stem_mode == "dense_block":
        need.append("stem_nb")
    return [n for n in need if n not in caps]
