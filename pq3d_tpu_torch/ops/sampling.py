"""Point sampling and grouping (the PointNet++ substrate); counterpart of
``pq3d_tpu/ops/sampling.py``.

- ``fps_numpy``: host-side furthest point sampling for query
  initialization in the stage-1 pipeline;
- the device functions, single-cloud and batched: furthest point sampling,
  the first-hit ball query, grouping, and 3-NN interpolation.

Semantics follow the JAX functions exactly: FPS starts at index 0 and
takes the first maximum (``torch.argmax`` returns the first, as
``jnp.argmax`` does), with squared distances summed x, y, z in that order;
the ball query returns the first ``nsample`` hits in index order and fills
misses with the row's first hit (0 when a row has none); 3-NN breaks
distance ties towards the lower index.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# Device functions
# ---------------------------------------------------------------------------

def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum((a - b)^2) over the last (xyz) axis, added x, y, z in order:
    the JAX reduction's order, which FPS's argmax ties depend on (the
    expanded |a|^2 - 2ab + |b|^2 form changes the picks).  Bf16 inputs
    are differenced, squared and summed in f32 and the sum rounded back
    once, as XLA computes the fused bf16 expression."""
    d = a.float() - b.float()
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
            + d[..., 2] * d[..., 2]).to(a.dtype)


def _first_k_hits(ok: torch.Tensor, nsample: int) -> torch.Tensor:
    """(..., M, N) hit mask -> (..., M, nsample) indices of the first
    ``nsample`` True columns per row, in index order; misses hold N."""
    n = ok.shape[-1]
    iota = torch.arange(n, device=ok.device, dtype=torch.int32)
    if nsample > n:
        raise ValueError(f"nsample {nsample} exceeds the {n} points")
    key = torch.where(ok, iota, n)
    # the smallest keys in ascending order: ties are all N, so the values
    # are the same whatever order a sort keeps among equal keys
    return torch.sort(key, dim=-1).values[..., :nsample]


def _fill_first(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Replace misses (== n) with the row's first hit; 0 when none."""
    first = idx[..., :1]
    idx = torch.where(idx < n, idx, first)
    return torch.where(first < n, idx, 0).to(torch.int32)


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative FPS on one cloud from index 0: (N, 3) -> (npoint,) int32
    indices."""
    mind = torch.full(xyz.shape[:1], float("inf"), dtype=xyz.dtype,
                      device=xyz.device)
    last = torch.zeros((), dtype=torch.long, device=xyz.device)
    picks = []
    for _ in range(npoint):
        picks.append(last)
        mind = torch.minimum(mind, _sqdist(xyz, xyz[last]))
        last = torch.argmax(mind)
    return torch.stack(picks).to(torch.int32)


def furthest_point_sample_batched(xyz: torch.Tensor, npoint: int
                                  ) -> torch.Tensor:
    """Batched iterative FPS: (B, N, 3) -> (B, npoint) int32."""
    b = xyz.shape[0]
    mind = torch.full(xyz.shape[:2], float("inf"), dtype=xyz.dtype,
                      device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    picks = []
    for _ in range(npoint):
        picks.append(last)
        sel = xyz[rows, last]                               # (B, 3)
        mind = torch.minimum(mind, _sqdist(xyz, sel[:, None, :]))
        last = torch.argmax(mind, dim=-1)
    return torch.stack(picks, 1).to(torch.int32)


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """First ``nsample`` points strictly within ``radius`` of each center:
    (N, 3), (M, 3) -> (M, nsample) int32."""
    ok = _sqdist(centers[:, None, :], xyz[None, :, :]) < radius * radius
    return _fill_first(_first_k_hits(ok, nsample), xyz.shape[0])


def ball_query_batched(xyz: torch.Tensor, centers: torch.Tensor,
                       radius: float, nsample: int) -> torch.Tensor:
    """Batched first-hit ball query: (B, N, 3), (B, M, 3) -> (B, M, S)."""
    ok = _sqdist(centers[:, :, None, :], xyz[:, None, :, :]) \
        < radius * radius
    return _fill_first(_first_k_hits(ok, nsample), xyz.shape[1])


def group_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather (N, C) features by (M, S) indices -> (M, S, C)."""
    return feats[idx.long()]


def query_and_group(xyz: torch.Tensor, centers: torch.Tensor,
                    feats: Optional[torch.Tensor], radius: float,
                    nsample: int, use_xyz: bool = True) -> torch.Tensor:
    """Ball query + grouping + center-relative xyz concat:
    -> (M, nsample, C')."""
    idx = ball_query(xyz, centers, radius, nsample).long()
    grouped_xyz = xyz[idx] - centers[:, None, :]
    if feats is None:
        return grouped_xyz
    grouped = feats[idx]
    if use_xyz:
        grouped = torch.cat([grouped_xyz, grouped], -1)
    return grouped


def _batched_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, ...) int -> (B, ..., C): x[b, idx[b, ...]]."""
    b = x.shape[0]
    rows = torch.arange(b, device=x.device).reshape(
        (b,) + (1,) * (idx.dim() - 1))
    return x[rows, idx.long()]


def gather_centers_batched(xyz: torch.Tensor, idx: torch.Tensor
                           ) -> torch.Tensor:
    """(B, N, C), (B, M) -> (B, M, C)."""
    return _batched_take(xyz, idx)


def query_and_group_batched(xyz: torch.Tensor, centers: torch.Tensor,
                            feats: Optional[torch.Tensor], radius: float,
                            nsample: int, use_xyz: bool = True
                            ) -> torch.Tensor:
    """Batched ball query + grouping: -> (B, M, nsample, C')."""
    idx = ball_query_batched(xyz, centers, radius, nsample)   # (B, M, S)
    grouped_xyz = _batched_take(xyz, idx) - centers[:, :, None, :]
    if feats is None:
        return grouped_xyz
    gf = _batched_take(feats, idx)
    if use_xyz:
        gf = torch.cat([grouped_xyz, gf], -1)
    return gf


def three_nn(unknown: torch.Tensor, known: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3 nearest known points of each unknown point: (n, 3), (m, 3) ->
    (dist (n, 3), idx (n, 3) int32); equal distances keep index order."""
    d2 = _sqdist(unknown[:, None, :], known[None, :, :])
    d2s, idx = torch.sort(d2, dim=-1, stable=True)
    return (torch.sqrt(torch.clamp_min(d2s[:, :3], 1e-10)),
            idx[:, :3].to(torch.int32))


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted sum of 3-NN features: (m, C), (n, 3), (n, 3) -> (n, C)."""
    return torch.einsum("nk,nkc->nc", weight, feats[idx.long()])


def three_interpolate_weights(unknown: torch.Tensor, known: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse-distance weights over the 3 NN: (idx, w)."""
    dist, idx = three_nn(unknown, known)
    inv = 1.0 / torch.clamp_min(dist, 1e-8)
    return idx, inv / inv.sum(-1, keepdim=True)
