"""Segment (scatter) pooling with ``index_add_``; counterpart of
``pq3d_tpu/ops/segment.py`` (replaces torch_scatter's scatter_mean)."""
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
