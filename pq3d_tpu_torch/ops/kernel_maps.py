"""Host-side sparse-convolution kernel maps (numpy); copy of
``pq3d_tpu/ops/kernel_maps.py``.

Replaces the MinkowskiEngine coordinate manager.  All maps are built on the
host inside the input pipeline, per scene, and padded to static sizes.
Convolutions become gather->GEMM on the device: for output voxel ``j`` and
kernel offset ``k``, ``nbr[j, k]`` is the index of the contributing input
voxel (or ``-1``).  Stride-2 down convs use per-coarse-voxel child maps
(K=8); transpose convs use parent index + offset-id gathers.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from pq3d_tpu_torch.ops._native import lib

NUM_LEVELS = 5  # stride 1, 2, 4, 8, 16


def _keys_for(coords: np.ndarray, base: np.ndarray, dims: np.ndarray
              ) -> np.ndarray:
    """Injective int64 key for integer coords within [base, base+dims)."""
    shifted = (coords - base).astype(np.int64)
    key = shifted[:, 0]
    for d in range(1, coords.shape[1]):
        key = key * np.int64(dims[d]) + shifted[:, d]
    return key


class CoordTable:
    """Coord -> index lookup reusable across all kernel offsets (numpy
    fallback when the native library is unavailable): a dense int32 grid
    when the bounding volume is small, one sorted-key table otherwise."""

    DENSE_LIMIT = 80_000_000  # cells (~320 MB int32)

    def __init__(self, coords: np.ndarray, margin: int = 3):
        self._margin = margin
        self.n = len(coords)
        if self.n == 0:
            self.lo = np.zeros(3, np.int64)
            self.dims = np.ones(3, np.int64)
            self.grid = None
            self.sorted_keys = np.zeros(0, np.int64)
            self.order = np.zeros(0, np.int64)
            return
        self.lo = coords.min(0).astype(np.int64) - margin
        self.dims = (coords.max(0).astype(np.int64) - self.lo + 1 + margin)
        volume = int(np.prod(self.dims))
        if volume <= self.DENSE_LIMIT:
            self.grid = np.full(volume, -1, np.int32)
            self.grid[_keys_for(coords, self.lo, self.dims)] = \
                np.arange(self.n, dtype=np.int32)
        else:
            self.grid = None
            keys = _keys_for(coords, self.lo, self.dims)
            self.order = np.argsort(keys, kind="stable")
            self.sorted_keys = keys[self.order]

    def lookup(self, query_coords: np.ndarray) -> np.ndarray:
        if self.n == 0 or len(query_coords) == 0:
            return np.full(len(query_coords), -1, dtype=np.int32)
        shifted = query_coords.astype(np.int64) - self.lo
        inside = ((shifted >= 0) & (shifted < self.dims)).all(1)
        key = (shifted[:, 0] * self.dims[1] + shifted[:, 1]) * self.dims[2] \
            + shifted[:, 2]
        key = np.where(inside, key, 0)
        if self.grid is not None:
            return np.where(inside, self.grid[key], -1).astype(np.int32)
        pos = np.searchsorted(self.sorted_keys, key)
        pos_c = np.minimum(pos, self.n - 1)
        hit = (self.sorted_keys[pos_c] == key) & inside
        return np.where(hit, self.order[pos_c], -1).astype(np.int32)

    def lookup_offsets(self, coords: np.ndarray, offsets: np.ndarray
                       ) -> np.ndarray:
        """(N, 3) coords x (K, 3) offsets -> (N, K) neighbor indices."""
        max_off = int(np.abs(offsets).max())
        if self.grid is None or max_off > self._margin:
            out = np.empty((len(coords), len(offsets)), np.int32)
            for k, off in enumerate(offsets):
                out[:, k] = self.lookup(coords + off[None, :])
            return out
        shifted = coords.astype(np.int64) - self.lo
        base = (shifted[:, 0] * self.dims[1] + shifted[:, 1]) * self.dims[2] \
            + shifted[:, 2]
        deltas = (offsets[:, 0].astype(np.int64) * self.dims[1]
                  + offsets[:, 1]) * self.dims[2] + offsets[:, 2]
        out = np.empty((len(coords), len(offsets)), np.int32)
        for k in range(len(offsets)):
            out[:, k] = self.grid[base + deltas[k]]
        return out


def kernel_offsets(kernel_size: int, ndim: int = 3) -> np.ndarray:
    """Integer offsets of a hypercubic kernel, ME ordering convention
    (range centered at 0 for odd sizes, [0, k) for even sizes); the last
    axis (z) varies fastest."""
    if kernel_size % 2 == 1:
        r = np.arange(-(kernel_size // 2), kernel_size // 2 + 1)
    else:
        r = np.arange(kernel_size)
    grids = np.meshgrid(*([r] * ndim), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1).astype(np.int32)


def build_neighbor_map(coords: np.ndarray, kernel_size: int,
                       n_pad: Optional[int] = None) -> np.ndarray:
    """Stride-1 conv map on one coordinate set: (N, K) indices, -1 = missing.
    ``n_pad`` pads the output rows (rows >= N are -1)."""
    offs = kernel_offsets(kernel_size)
    L = lib()
    if L is not None:
        c = np.ascontiguousarray(coords, np.int32)
        o = np.ascontiguousarray(offs, np.int32)
        n = len(c)
        if n and int(np.abs(c).max()) >= (1 << 20) - 4:
            # the native key packs biased coords into 21-bit fields
            raise ValueError(
                f"voxel coords exceed the native packer's +-2^20 range "
                f"(max abs {int(np.abs(c).max())}); re-origin the scene")
        rows = int(n_pad) if n_pad else n
        out = np.empty((rows, len(o)), np.int32)
        L.pq3d_neighbor_map(c.ctypes.data, n, o.ctypes.data, len(o),
                            rows, out.ctypes.data)
        return out
    table = CoordTable(coords, margin=max(3, kernel_size // 2 + 1))
    nbr = table.lookup_offsets(coords, offs)
    if n_pad:
        nbr = pad_rows(nbr, int(n_pad), -1)
    return nbr


def morton_order(coords: np.ndarray, bits: int = 10) -> np.ndarray:
    """Permutation sorting integer coords by Morton (z-order) code, ``bits``
    per axis (coords past 2^bits - 1 from the minimum are clipped), stable.

    Spatially near voxels become index-near, so a sparse conv's neighbour
    indices gather around the diagonal: the windowed conv
    (ops/windowed_conv.py) reads each output tile's neighbours from one
    contiguous slab of rows.
    """
    c = (coords - coords.min(0)).astype(np.uint64)
    c = np.minimum(c, (1 << bits) - 1)
    code = np.zeros(len(c), dtype=np.uint64)
    for b in range(bits):
        for d in range(3):
            code |= ((c[:, d] >> np.uint64(b)) & np.uint64(1)) << \
                np.uint64(3 * b + d)
    return np.argsort(code, kind="stable")


def build_block_pack(coords: np.ndarray, block: int = 8
                     ) -> Dict[str, np.ndarray]:
    """Pack sparse voxels into dense ``block^3`` spatial blocks (the JAX
    package's ``build_block_pack``): inside an occupied block a conv is a
    dense 3D conv, and blocks exchange halos through whole-block gathers.

    Returns dict:
      vox_slot   (N,)  flat dense-cell index (block_id * block^3 + cell)
      nbr_blocks (n_blocks, 3, 3, 3) neighbor block ids (-1 outside)
      n_blocks   scalar int
    """
    bcoord = np.floor_divide(coords, block)
    lo = bcoord.min(0) if len(bcoord) else np.zeros(3, np.int64)
    bshift = bcoord - lo
    dims = bshift.max(0) + 1 if len(bshift) else np.ones(3, np.int64)
    key = (bshift[:, 0].astype(np.int64) * dims[1] + bshift[:, 1]) * dims[2] \
        + bshift[:, 2]
    ukeys, binv = np.unique(key, return_inverse=True)
    n_blocks = len(ukeys)
    local = coords - bcoord * block
    cell = (local[:, 0] * block + local[:, 1]) * block + local[:, 2]
    vox_slot = (binv * block ** 3 + cell).astype(np.int32)

    ub = np.stack([ukeys // (dims[1] * dims[2]),
                   (ukeys // dims[2]) % dims[1],
                   ukeys % dims[2]], axis=1)
    nbr_blocks = np.full((n_blocks, 3, 3, 3), -1, np.int32)
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                q = ub + np.array([dx - 1, dy - 1, dz - 1])
                inside = ((q >= 0) & (q < dims)).all(1)
                qk = (q[:, 0] * dims[1] + q[:, 1]) * dims[2] + q[:, 2]
                pos = np.searchsorted(ukeys, qk)
                pos_c = np.minimum(pos, n_blocks - 1)
                hit = (ukeys[pos_c] == qk) & inside
                nbr_blocks[:, dx, dy, dz] = np.where(hit, pos_c, -1)
    return {"vox_slot": vox_slot, "nbr_blocks": nbr_blocks,
            "n_blocks": n_blocks}


def downsample_coords(coords: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stride-2 coordinate downsampling.

    Returns ``(coarse_coords, parent_idx, offset_id)`` where
    ``coarse_coords[parent_idx[i]] * 2 + offset(offset_id[i]) == coords[i]``;
    coarse coords come out in ascending ravel-key order.
    """
    L = lib()
    if L is not None and coords.shape[1] == 3 and len(coords) \
            and int(np.abs(coords).max()) < (1 << 20) - 4:
        c = np.ascontiguousarray(coords, np.int32)
        n = len(c)
        coarse = np.empty((n, 3), np.int32)
        parent = np.empty(n, np.int32)
        off = np.empty(n, np.int32)
        m = L.pq3d_downsample(c.ctypes.data, n, coarse.ctypes.data,
                              parent.ctypes.data, off.ctypes.data)
        return coarse[:m].copy(), parent, off
    coarse_all = np.floor_divide(coords, 2)
    lo = coarse_all.min(0) if len(coarse_all) else \
        np.zeros(coords.shape[1], np.int32)
    hi = coarse_all.max(0) if len(coarse_all) else \
        np.zeros(coords.shape[1], np.int32)
    dims = (hi - lo + 1).astype(np.int64)
    keys = _keys_for(coarse_all, lo, dims)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    first = np.ones(len(keys), dtype=bool)
    if len(keys):
        first[1:] = sk[1:] != sk[:-1]
    coarse = coarse_all[order[first]]
    group = np.cumsum(first) - 1
    parent = np.empty(len(keys), dtype=np.int32)
    parent[order] = group.astype(np.int32)
    rem = coords - coarse_all * 2
    off_id = (rem[:, -3] * 4 + rem[:, -2] * 2 + rem[:, -1]).astype(np.int32)
    return coarse.astype(np.int32), parent, off_id


def build_child_map(parent_idx: np.ndarray, offset_id: np.ndarray,
                    num_coarse: int) -> np.ndarray:
    """Invert (parent, offset) -> (num_coarse, 8) fine indices, -1 = missing."""
    child = np.full((num_coarse, 8), -1, dtype=np.int32)
    child[parent_idx, offset_id] = np.arange(len(parent_idx), dtype=np.int32)
    return child


def pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad (or verify) leading dim of ``a`` to exactly ``n`` rows."""
    if len(a) > n:
        raise ValueError(f"cannot pad {len(a)} rows into {n}")
    if len(a) == n:
        return a
    pad_shape = (n - len(a),) + a.shape[1:]
    return np.concatenate([a, np.full(pad_shape, fill, dtype=a.dtype)],
                          axis=0)


@dataclass
class SparseHierarchy:
    """Per-scene static-shape sparse-conv plan (host-built); every index
    array uses -1 for "missing"."""
    num_voxels: List[int]                 # true counts per level
    pad_sizes: List[int]                  # static padded sizes per level
    valid: List[np.ndarray]               # (P_l,) bool
    nbr3: List[np.ndarray]                # level l: (P_l, 27) int32
    child: List[np.ndarray]               # l -> (P_{l+1}, 8) fine idx
    parent: List[np.ndarray]              # l -> (P_l,) coarse idx (-1 pad)
    parent_off: List[np.ndarray]          # l -> (P_l,) offset id in [0,8)
    # ancestor of each level-0 voxel at every level (FPN pooling)
    ancestor: np.ndarray = field(default=None)  # (NUM_LEVELS, P_0) int32
    # unpadded (num_voxels[l], 3) int32 coords of each level
    coords: List[np.ndarray] = field(default=None)


def bucket_pad_sizes(counts: List[int], bucket: int = 4096,
                     caps: Optional[List[int]] = None) -> List[int]:
    """Static pad size per level: round each count up to a bucket multiple."""
    sizes = [max(bucket, int(np.ceil(n / bucket)) * bucket) for n in counts]
    if caps:
        sizes = [min(s, c) if c else s for s, c in zip(sizes, caps)]
    return sizes


def build_hierarchy(coords0: np.ndarray,
                    pad_sizes: Optional[List[int]] = None,
                    bucket: int = 4096) -> SparseHierarchy:
    """Build the coordinate pyramid + every 3^3 / stride-2 map of one scene.

    A level whose voxel count exceeds its configured pad falls back to a
    bucketed pad for that scene (with a warning) instead of failing.
    """
    levels = [coords0.astype(np.int32)]
    parents, offs = [], []
    for _ in range(NUM_LEVELS - 1):
        coarse, parent, off = downsample_coords(levels[-1])
        levels.append(coarse)
        parents.append(parent)
        offs.append(off)

    num_voxels = [len(c) for c in levels]
    if pad_sizes is None:
        pad_sizes = bucket_pad_sizes(num_voxels, bucket=bucket)
    else:
        pad_sizes = list(pad_sizes)
        for l in range(NUM_LEVELS):
            if num_voxels[l] > pad_sizes[l]:
                grown = bucket_pad_sizes(num_voxels, bucket=bucket)[l]
                warnings.warn(
                    f"level {l} has {num_voxels[l]} voxels > configured cap "
                    f"{pad_sizes[l]}; padding to {grown} for this scene "
                    f"(raise level_caps[{l}] to avoid)")
                pad_sizes[l] = grown

    nbr3 = [build_neighbor_map(levels[l], 3, n_pad=pad_sizes[l])
            for l in range(NUM_LEVELS)]
    child = [build_child_map(parents[l], offs[l], num_voxels[l + 1])
             for l in range(NUM_LEVELS - 1)]

    anc = np.zeros((NUM_LEVELS, pad_sizes[0]), dtype=np.int32)
    cur = np.arange(num_voxels[0], dtype=np.int32)
    anc[0, :num_voxels[0]] = cur
    for l in range(NUM_LEVELS - 1):
        cur = parents[l][cur]
        anc[l + 1, :num_voxels[0]] = cur

    return SparseHierarchy(
        num_voxels=num_voxels,
        pad_sizes=list(pad_sizes),
        valid=[pad_rows(np.ones(num_voxels[l], dtype=bool), pad_sizes[l],
                        False) for l in range(NUM_LEVELS)],
        nbr3=[pad_rows(nbr3[l], pad_sizes[l], -1) for l in range(NUM_LEVELS)],
        child=[pad_rows(child[l], pad_sizes[l + 1], -1)
               for l in range(NUM_LEVELS - 1)],
        parent=[pad_rows(parents[l].astype(np.int32), pad_sizes[l], -1)
                for l in range(NUM_LEVELS - 1)],
        parent_off=[pad_rows(offs[l], pad_sizes[l], 0)
                    for l in range(NUM_LEVELS - 1)],
        ancestor=anc,
        coords=levels,
    )


def build_ztriple_plan(nbr: np.ndarray, n_pad: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """z-run fetch plan of a (N, 27) stride-1 neighbor map (the JAX
    package's ``build_ztriple_plan``; ``ops/zrun_conv.zrun_plan`` builds
    the same plan on the device).

    Voxel rows are ravel-key sorted with z fastest (ops/voxelize), so the
    up-to-3 z-neighbours of each of the 9 (dy, dx) kernel columns occupy
    consecutive rows.  Returns ``(base (N, 9) int32, codes (N, 9, 3)
    int8)``: ``base[o, c]`` is the first row of output o / column c's
    z-run, clamped to [0, n_pad-3] so a 3-row fetch stays in bounds (0
    when the column has no neighbour); ``codes[o, c, p]`` is the kernel
    z-offset (-1/0/+1) carried by fetched slot p, or -2.  Tap order is
    z-fastest (kernel_offsets): tap = 3*c + dz + 1.
    """
    if n_pad is None:
        n_pad = nbr.shape[0]
    big = np.iinfo(np.int64).max
    nbrr = nbr.reshape(-1, 9, 3).astype(np.int64)
    base = np.where(nbrr >= 0, nbrr, big).min(2)
    has = base != big
    base = np.where(has, np.minimum(base, n_pad - 3), 0)
    codes = np.full((len(nbr), 9, 3), -2, np.int8)
    for p in range(3):
        for d in range(3):
            m = has & (nbrr[:, :, d] == base + p)
            codes[:, :, p] = np.where(m, d - 1, codes[:, :, p])
    return base.astype(np.int32), codes


# a compact plan's arrays as a batch ships them: map ``cmp{l}_{short}``
# holds the plan's ``key`` (data/instseg_pipeline.collate_flat)
COMPACT_MAP_KEYS = (("in", "in_idx"), ("out", "out_idx"), ("sa", "slots_a"),
                    ("sb", "slots_b"), ("src", "src"))


def build_compact_conv(nbr: np.ndarray, m_bucket: int = 1024,
                       light_slots: int = 8, row_bucket: int = 512
                       ) -> Dict[str, np.ndarray]:
    """Tap-compacted (CSR) conv plan of a (N, K) neighbor map (the JAX
    package's ``build_compact_conv``, array for array).

    Only the valid (output, tap) pairs are gathered, and each output row
    collects its partial products by static addresses, with no scatter:

      in_idx  (K, M)      input row of each valid pair of tap k (pad -1),
                          rows ascending within a tap; the pair's partial
                          product lives at flat address k*M + j;
      out_idx (K, M)      the pair's output row (for dW), pad -1;
      slots_a (Na, light) the addresses of the outputs with 1..light valid
                          taps, in tap order, pad -1;
      slots_b (Nb, K)     the same for the heavier outputs;
      src     (N,)        output row -> its compact row (A first, then B;
                          rows with no valid tap -> the zero row Na+Nb);
      n_out               N.

    M is bucketed up by ``m_bucket``, Na and Nb by ``row_bucket``.
    """
    n, k = nbr.shape
    valid = nbr >= 0
    cnt = valid.sum(1)
    cnt_t = valid.sum(0)
    m = int(cnt_t.max()) if n else 0
    m = max(m_bucket, int(np.ceil(m / m_bucket)) * m_bucket)
    in_idx = np.full((k, m), -1, np.int32)
    out_idx = np.full((k, m), -1, np.int32)
    # one tap-major nonzero pass: rows ascending within each tap
    addr = np.full((n, k), -1, np.int64)
    t_idx, rows = np.nonzero(valid.T)
    starts = np.zeros(k, np.int64)
    np.cumsum(cnt_t[:-1], out=starts[1:])
    pos = np.arange(len(rows), dtype=np.int64) - starts[t_idx]
    in_idx[t_idx, pos] = nbr[rows, t_idx]
    out_idx[t_idx, pos] = rows
    addr[rows, t_idx] = t_idx * m + pos

    la = np.nonzero((cnt <= light_slots) & (cnt > 0))[0]
    hb = np.nonzero(cnt > light_slots)[0]

    def bucket_rows(x):
        return max(row_bucket, int(np.ceil(max(len(x), 1) / row_bucket))
                   * row_bucket)

    na, nb = bucket_rows(la), bucket_rows(hb)

    def compacted(sel, width):
        # a row-major nonzero pass keeps each row's addresses in tap order
        out = np.full((len(sel), width), -1, np.int32)
        if len(sel):
            a = addr[sel]
            r_idx, t2 = np.nonzero(a >= 0)
            rs = np.zeros(len(sel), np.int64)
            np.cumsum((a >= 0).sum(1)[:-1], out=rs[1:])
            p = np.arange(len(r_idx), dtype=np.int64) - rs[r_idx]
            keep = p < width
            out[r_idx[keep], p[keep]] = a[r_idx[keep], t2[keep]]
        return out

    slots_a = np.full((na, light_slots), -1, np.int32)
    slots_a[:len(la)] = compacted(la, light_slots)
    slots_b = np.full((nb, k), -1, np.int32)
    slots_b[:len(hb)] = compacted(hb, k)
    src = np.full(n, na + nb, np.int32)
    src[la] = np.arange(len(la), dtype=np.int32)
    src[hb] = na + np.arange(len(hb), dtype=np.int32)
    return {"in_idx": in_idx, "out_idx": out_idx, "slots_a": slots_a,
            "slots_b": slots_b, "src": src, "n_out": n}
