"""Segment (scatter) pooling with ``index_add_`` and ``scatter_reduce_``;
counterpart of ``pq3d_tpu/ops/segment.py`` (replaces torch_scatter's
scatter_mean)."""
from __future__ import annotations

import torch


def segment_sum(x: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum rows of ``x`` into ``num_segments`` buckets; ids outside
    [0, num_segments) (e.g. padded voxels in a trash bucket) are dropped."""
    ids = seg_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    out.index_add_(0, ids, x)
    return out[:num_segments]


def segment_mean(x: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean-pool rows of ``x`` per segment (empty segments -> 0)."""
    sums = segment_sum(x, seg_ids, num_segments)
    cnt = segment_sum(torch.ones(x.shape[0], 1, dtype=x.dtype,
                                 device=x.device), seg_ids, num_segments)
    return sums / cnt.clamp_min(1)


def segment_max(x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                fill_value: float = 0.0) -> torch.Tensor:
    """Max-pool rows of ``x`` per segment; empty segments (and any
    non-finite maximum) give ``fill_value``; ids outside [0, num_segments)
    are dropped."""
    ids = seg_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    lowest = (float("-inf") if x.dtype.is_floating_point
              else torch.iinfo(x.dtype).min)
    out = torch.full((num_segments + 1,) + tuple(x.shape[1:]), lowest,
                     dtype=x.dtype, device=x.device)
    idx = ids.view((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    out.scatter_reduce_(0, idx, x, reduce="amax")
    out = out[:num_segments]
    return torch.where(torch.isfinite(out), out,
                       torch.tensor(fill_value, dtype=x.dtype,
                                    device=x.device))
