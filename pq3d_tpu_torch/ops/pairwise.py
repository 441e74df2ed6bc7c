"""Pairwise spatial relation features between query centers; counterpart
of ``pq3d_tpu/ops/pairwise.py`` (the 'center' relation the stage-1 model
uses): [normalized distance, dz/dist, dist2d/dist, dy/dist2d, dx/dist2d]."""
from __future__ import annotations

import torch


def calc_pairwise_locs(centers: torch.Tensor, eps: float = 1e-10,
                       spatial_dist_norm: bool = True,
                       spatial_dim: int = 5) -> torch.Tensor:
    """(B, L, 3) -> (B, L, L, spatial_dim) pairwise spatial features."""
    rel = centers[:, :, None, :] - centers[:, None, :, :]        # (B,L,L,3)
    dist = torch.sqrt(torch.sum(rel ** 2, dim=-1) + eps)         # (B,L,L)
    if spatial_dist_norm:
        max_dist = dist.reshape(dist.shape[0], -1).amax(1)
        norm_dist = dist / max_dist[:, None, None]
    else:
        norm_dist = dist
    if spatial_dim == 1:
        return norm_dist[..., None]
    dist2d = torch.sqrt(torch.sum(rel[..., :2] ** 2, dim=-1) + eps)
    feats = torch.stack([
        norm_dist,
        rel[..., 2] / dist,
        dist2d / dist,
        rel[..., 1] / dist2d,
        rel[..., 0] / dist2d,
    ], dim=-1)
    if spatial_dim == 4:
        feats = feats[..., 1:]
    return feats
