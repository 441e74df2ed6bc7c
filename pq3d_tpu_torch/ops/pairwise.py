"""Pairwise spatial relation features between query centers; counterpart
of ``pq3d_tpu/ops/pairwise.py``: [normalized distance, dz/dist,
dist2d/dist, dy/dist2d, dx/dist2d] for ``center``; ``vertical_bottom``
takes dz, dist and dist2d between the boxes' bottoms (the centers lowered
by ``whls``' third column, the centers themselves without ``whls``);
``mlp`` returns each pair's concatenated (center, whl) rows."""
from __future__ import annotations

from typing import Optional

import torch


def calc_pairwise_locs(centers: torch.Tensor,
                       whls: Optional[torch.Tensor] = None,
                       eps: float = 1e-10, pairwise_rel_type: str = "center",
                       spatial_dist_norm: bool = True,
                       spatial_dim: int = 5) -> torch.Tensor:
    """(B, L, 3) -> (B, L, L, spatial_dim) pairwise spatial features
    (``mlp``: (B, L, L, 2 (3 + whl dims)))."""
    if pairwise_rel_type == "mlp":
        if whls is None:
            raise ValueError("pairwise_rel_type 'mlp' needs whls")
        locs = torch.cat([centers, whls], dim=-1)
        a = locs[:, :, None, :].expand(-1, -1, locs.shape[1], -1)
        b = locs[:, None, :, :].expand_as(a)
        return torch.cat([a, b], dim=-1)

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
    if pairwise_rel_type == "center":
        feats = torch.stack([
            norm_dist,
            rel[..., 2] / dist,
            dist2d / dist,
            rel[..., 1] / dist2d,
            rel[..., 0] / dist2d,
        ], dim=-1)
    elif pairwise_rel_type == "vertical_bottom":
        bottom = centers
        if whls is not None:
            bottom = torch.cat([centers[..., :2],
                                centers[..., 2:3] - whls[..., 2:3]], dim=-1)
        brel = bottom[:, :, None, :] - bottom[:, None, :, :]
        bdist = torch.sqrt(torch.sum(brel ** 2, dim=-1) + eps)
        bdist2d = torch.sqrt(torch.sum(brel[..., :2] ** 2, dim=-1) + eps)
        feats = torch.stack([
            norm_dist,
            brel[..., 2] / bdist,
            bdist2d / bdist,
            rel[..., 1] / dist2d,
            rel[..., 0] / dist2d,
        ], dim=-1)
    else:
        raise NotImplementedError(pairwise_rel_type)
    if spatial_dim == 4:
        feats = feats[..., 1:]
    return feats
