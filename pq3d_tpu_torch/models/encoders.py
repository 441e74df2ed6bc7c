"""Vision / memory encoders (PyTorch); counterpart of
``pq3d_tpu/models/encoders.py``:

- SegVoxelEncoder: Res16UNet -> per-scale segment-pooled features
  (rectangular layout);
- ObjectEncoder: per-segment feature projection without a point backbone.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn

from pq3d_tpu_torch.models.layers import FLAX_LN_EPS
from pq3d_tpu_torch.models.sparse_unet import Res16UNet, flatten_maps
from pq3d_tpu_torch.ops import segment


class ProjectLN(nn.Module):
    """Linear + LayerNorm + Dropout projection block."""

    def __init__(self, in_size: int, hidden_size: int, dropout: float = 0.0):
        super().__init__()
        self.Dense_0 = nn.Linear(in_size, hidden_size)
        self.LayerNorm_0 = nn.LayerNorm(hidden_size, eps=FLAX_LN_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        return self.drop(self.LayerNorm_0(self.Dense_0(x)))


class SegVoxelEncoder(nn.Module):
    """Voxel U-Net -> per-scale segment-pooled features.

    For each hlevel (plus the final level-0 map) the decoder feature map is
    mean-pooled onto segments and projected.  Coarse levels pool through a
    count matrix: ``mean[s] = (counts @ feat)[s] / n_s`` with
    ``counts[j, s]`` = the number of level-0 voxels with ancestor j and
    segment s, which equals broadcasting coarse features to every level-0
    voxel and scatter-meaning.  Output: list over hlevels+[final] of
    (B, max_seg, hidden).
    """

    def __init__(self, hidden_size: int = 768,
                 hlevels: Sequence[int] = (0, 1, 2, 3),
                 backbone_out_channels: int = 200,
                 conv1_kernel_size: int = 5, pallas_conv: bool = False,
                 in_channels: int = 3, dropout: float = 0.1,
                 bn_momentum: float = 0.02):
        super().__init__()
        self.hlevels = list(hlevels)
        # the backbone's `final` output (backbone_out_channels) is not used
        # here: its parameters get a zero gradient and are still decayed
        self.backbone = Res16UNet(in_channels=in_channels,
                                  out_channels=backbone_out_channels,
                                  conv1_kernel_size=conv1_kernel_size,
                                  pallas_conv=pallas_conv,
                                  bn_momentum=bn_momentum)
        # channels of feature_maps [L4, L3, L2, L1, L0]: the encoder's last
        # stage, then the four decoder stages
        P = self.backbone.planes
        p = [P[3]] + P[4:8]
        for i, hlevel in enumerate(self.hlevels + [4]):
            self.add_module(f"feat_proj_{i}", ProjectLN(p[hlevel],
                                                        hidden_size, dropout))

    def forward(self, voxel_feats: torch.Tensor,
                maps: Dict[str, torch.Tensor], voxel2segment: torch.Tensor,
                max_seg: int) -> List[torch.Tensor]:
        _, feature_maps = self.backbone(voxel_feats, maps)
        fm = flatten_maps(maps)
        b, p0 = maps["valid_0"].shape
        dev = voxel_feats.device
        scene = torch.arange(b, device=dev).repeat_interleave(p0)
        valid0 = fm["valid_0"]
        v2s = voxel2segment.reshape(-1).long()
        flat_seg = torch.where(v2s < max_seg, scene * max_seg + v2s,
                               b * max_seg)
        n_s = segment.segment_sum(torch.ones(flat_seg.shape[0], device=dev),
                                  flat_seg, b * max_seg)
        n_s = n_s.clamp_min(1.0).reshape(b, max_seg, 1)
        s1 = max_seg + 1
        sl = v2s.clamp_max(max_seg)              # local seg id, trash = S

        out: List[torch.Tensor] = []
        for i, hlevel in enumerate(self.hlevels + [4]):
            feat = feature_maps[hlevel]          # (B*P_{4-hlevel}, C)
            lvl = 4 - hlevel
            if lvl > 0:
                p_l = maps[f"valid_{lvl}"].shape[1]
                anc = fm[f"ancestor_{lvl}"].clamp_min(0).long()
                feat_b = feat.reshape(b, p_l, -1)
                key = anc * s1 + sl
                counts = segment.segment_sum(
                    torch.ones(key.shape[0], device=dev), key, b * p_l * s1)
                counts = counts.reshape(b, p_l, s1)[:, :, :max_seg]
                seg_sum = torch.einsum("bjs,bjc->bsc", counts, feat_b.float())
                seg_feat = seg_sum / n_s
            else:
                feat = torch.where(valid0[:, None], feat, 0)
                seg_feat = segment.segment_mean(feat, flat_seg, b * max_seg)
                seg_feat = seg_feat.reshape(b, max_seg, -1)
            out.append(getattr(self, f"feat_proj_{i}")(seg_feat))
        return out


class ObjectEncoder(nn.Module):
    """Per-object/segment feature projection (Linear + LayerNorm +
    Dropout), without a point backbone."""

    def __init__(self, input_feat_size: int, hidden_size: int = 768,
                 dropout: float = 0.1):
        super().__init__()
        self.input_feat_proj = nn.Linear(input_feat_size, hidden_size)
        self.LayerNorm_0 = nn.LayerNorm(hidden_size, eps=FLAX_LN_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, obj_feats):
        return self.drop(self.LayerNorm_0(self.input_feat_proj(obj_feats)))
