"""3D-VisTA-style object encoders; counterpart of
``pq3d_tpu/models/legacy_encoders.py``.

PointNet++ features per object, with an optional stage of spatial
self-attention across the scene's objects.  No shipped config uses them;
they are here so that a config that names ``PcdObjEncoder`` or
``PointTokenizeEncoder`` finds them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from pq3d_tpu_torch.models.layers import SpatialSelfAttentionLayer
from pq3d_tpu_torch.models.pointnet import PointNetPP
from pq3d_tpu_torch.ops.pairwise import calc_pairwise_locs


def _object_features(backbone: PointNetPP, proj: Optional[nn.Linear],
                     obj_pcds: torch.Tensor) -> torch.Tensor:
    """(B, O, P, 3+C) object clouds -> (B, O, hidden) features."""
    b, o = obj_pcds.shape[:2]
    feats = backbone(obj_pcds.reshape((b * o,) + obj_pcds.shape[2:]))
    feats = feats.reshape(b, o, -1)
    return proj(feats) if proj is not None else feats


class PcdObjEncoder(nn.Module):
    """Per-object PointNet++ features of (B, O, P, 6) xyz + rgb clouds,
    projected to ``hidden_size`` when PointNet++'s width differs."""

    def __init__(self, hidden_size: int = 768, dropout: float = 0.1):
        super().__init__()
        self.backbone = PointNetPP()
        self.Dense_0 = (nn.Linear(self.backbone.out_channels, hidden_size)
                        if self.backbone.out_channels != hidden_size
                        else None)
        self.drop = nn.Dropout(dropout)

    def forward(self, obj_pcds: torch.Tensor) -> torch.Tensor:
        return self.drop(_object_features(self.backbone, self.Dense_0,
                                          obj_pcds))


class PointTokenizeEncoder(nn.Module):
    """PointNet++ tokens refined by ``num_layers`` pairwise-location-aware
    self-attention layers across the scene's objects (``obj_valid``: the
    keys each object may attend to)."""

    def __init__(self, hidden_size: int = 768, num_layers: int = 2,
                 num_heads: int = 12, dropout: float = 0.1,
                 spatial_dim: int = 5):
        super().__init__()
        self.spatial_dim = spatial_dim
        self.num_layers = num_layers
        self.backbone = PointNetPP()
        self.Dense_0 = (nn.Linear(self.backbone.out_channels, hidden_size)
                        if self.backbone.out_channels != hidden_size
                        else None)
        for i in range(num_layers):
            self.add_module(f"spatial_layer{i}", SpatialSelfAttentionLayer(
                hidden_size, num_heads, spatial_dim, dropout))

    def forward(self, obj_pcds: torch.Tensor, obj_locs: torch.Tensor,
                obj_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        feats = _object_features(self.backbone, self.Dense_0, obj_pcds)
        pairwise = calc_pairwise_locs(obj_locs[..., :3],
                                      spatial_dim=self.spatial_dim)
        for i in range(self.num_layers):
            feats = getattr(self, f"spatial_layer{i}")(
                feats, pairwise, key_attend_mask=obj_valid)
        return feats
