"""Vision / memory encoders (PyTorch); counterpart of
``pq3d_tpu/models/encoders.py``:

- SegVoxelEncoder: a voxel U-Net (Res16UNet, or the Swin3D window-
  attention U-Net of ``models/swin3d``) -> per-scale segment-pooled
  features (rectangular and flat-pack layouts); ``check_swin_window``
  holds a swin model and a pipeline to one window;
- ObjectEncoder: per-object (or per-segment) feature projection, with an
  optional PointNet++ backbone over raw object point clouds (the padded
  (B, O, P, 3+C) layout, or the flat one: the batch's real objects only);
- VoxelLevelEncoder (``PCDMask3DEncoder``): the U-Net's voxel-level mask
  features and per-level features, no segment pooling;
- SemanticEncoder: label embeddings of the predicted class distribution,
  with the prediction mixup curriculum (``mixup_predictions``,
  ``linear_decay_mixup_ratio``).
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from pq3d_tpu_torch.models.layers import FLAX_LN_EPS
from pq3d_tpu_torch.models.sparse_unet import Res16UNet, flatten_maps
from pq3d_tpu_torch.ops import segment, sparse


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

    ``backbone`` is ``"res16unet"`` or ``"swin3d"`` (``Swin3DUNet`` at the
    JAX package's defaults and ``swin_window``; the batch must carry the
    window packs).  Both take ``grad_mode``; ``remat_policy`` is the
    Res16UNet's, and any policy but ``'none'`` checkpoints the swin
    blocks.  The swin backbone has no conv-gather levers:
    ``sorted_gather``, ``int8_gather`` and ``pallas_conv`` are accepted
    there and do nothing, with a warning, as the JAX package prints one.

    For each hlevel (plus the final level-0 map) the decoder feature map is
    mean-pooled onto segments and projected.  Coarse levels pool through a
    count matrix: ``mean[s] = (counts @ feat)[s] / n_s`` with
    ``counts[j, s]`` = the number of level-0 voxels with ancestor j and
    segment s, which equals broadcasting coarse features to every level-0
    voxel and scatter-meaning.  In the flat-pack layout the batch's
    ``voxel_scene`` (scene of each level-0 row), ``anc_local`` (scene-local
    ancestors) and ``rect_{l}`` (each scene's rows of level l, -1 padded)
    rectangularize a coarse level with one gather first.  Output: list
    over hlevels+[final] of (B, max_seg, hidden).
    """

    def __init__(self, hidden_size: int = 768,
                 hlevels: Sequence[int] = (0, 1, 2, 3),
                 backbone_out_channels: int = 200,
                 conv1_kernel_size: int = 5, pallas_conv: bool = False,
                 in_channels: int = 3, dropout: float = 0.1,
                 bn_momentum: float = 0.02, backbone: str = "res16unet",
                 swin_window: int = 4, grad_mode: str = "scatter_free",
                 remat_policy: str = "none", sorted_gather: bool = False,
                 int8_gather: bool = False):
        super().__init__()
        self.hlevels = list(hlevels)
        # the backbone's `final` output (backbone_out_channels) is not used
        # here: its parameters get a zero gradient and are still decayed
        if backbone == "swin3d":
            from pq3d_tpu_torch.models.swin3d import Swin3DUNet
            dropped = [n for n, on in (("sorted_gather", sorted_gather),
                                       ("int8_gather", int8_gather),
                                       ("pallas_conv", pallas_conv)) if on]
            if dropped:
                warnings.warn(f"[SegVoxelEncoder] swin3d backbone has no "
                              f"{'/'.join(dropped)} — option(s) ignored",
                              stacklevel=2)
            self.backbone = Swin3DUNet(in_channels=in_channels,
                                       out_channels=backbone_out_channels,
                                       window=swin_window,
                                       bn_momentum=bn_momentum,
                                       grad_mode=grad_mode,
                                       remat=remat_policy != "none")
        elif backbone == "res16unet":
            self.backbone = Res16UNet(in_channels=in_channels,
                                      out_channels=backbone_out_channels,
                                      conv1_kernel_size=conv1_kernel_size,
                                      pallas_conv=pallas_conv,
                                      bn_momentum=bn_momentum,
                                      grad_mode=grad_mode,
                                      remat_policy=remat_policy,
                                      sorted_gather=sorted_gather,
                                      int8_gather=int8_gather)
        else:
            raise ValueError(f"voxel backbone {backbone!r} is not "
                             "'res16unet' or 'swin3d'")
        # channels of feature_maps [L4, L3, L2, L1, L0]
        p = self.backbone.feature_channels
        for i, hlevel in enumerate(self.hlevels + [4]):
            self.add_module(f"feat_proj_{i}", ProjectLN(p[hlevel],
                                                        hidden_size, dropout))

    def forward(self, voxel_feats: torch.Tensor,
                maps: Dict[str, torch.Tensor], voxel2segment: torch.Tensor,
                max_seg: int) -> List[torch.Tensor]:
        _, feature_maps = self.backbone(voxel_feats, maps)
        fm = flatten_maps(maps)
        dev = voxel_feats.device
        flat_in = maps["valid_0"].dim() == 1
        if flat_in:
            b = maps["rect_0"].shape[0]
            scene = maps["voxel_scene"].long()
        else:
            b, p0 = maps["valid_0"].shape
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
            if lvl > 0 and flat_in:
                rect = maps[f"rect_{lvl}"]
                p_l = rect.shape[1]
                feat_b = sparse._masked_gather(feat, rect.reshape(-1)) \
                    .reshape(b, p_l, -1)
                anc = scene * p_l + maps["anc_local"][lvl].long()
            elif lvl > 0:
                p_l = maps[f"valid_{lvl}"].shape[1]
                anc = fm[f"ancestor_{lvl}"].clamp_min(0).long()
                feat_b = feat.reshape(b, p_l, -1)
            if lvl > 0:
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
    """Per-object/segment feature projection (Linear + LayerNorm, then
    Dropout), optionally behind a PointNet++ backbone.

    With ``backbone="pointnet++"`` the input is (B, O, P, 3+C) object
    clouds and the projection reads the backbone's output width, not
    ``input_feat_size``.  A frozen backbone runs in BatchNorm eval mode
    (running statistics) under ``torch.no_grad``, also inside a model in
    train mode.  With ``flat_slot`` (B, O) the input is the flat layout's
    (F, P, 3+C) real object clouds: the backbone runs on those F, and row
    ``flat_slot[b, o]`` of its output, or an appended zero row where the
    slot holds F (padding), lands at (b, o).  The flat layout needs the
    backbone, and in training a frozen one (train-mode batch statistics
    over the flat rows would not be the padded layout's): both raise
    ``ValueError`` otherwise."""

    def __init__(self, input_feat_size: int, hidden_size: int = 768,
                 dropout: float = 0.1, use_projection: bool = True,
                 backbone: str = "none", freeze_backbone: bool = False):
        super().__init__()
        if backbone not in ("none", "pointnet++"):
            raise NotImplementedError(f"object backbone {backbone!r}")
        self.freeze_backbone = freeze_backbone
        self.use_projection = use_projection
        if backbone == "pointnet++":
            from pq3d_tpu_torch.models.pointnet import PointNetPP
            self.backbone = PointNetPP()      # xyz + rgb points
            input_feat_size = self.backbone.out_channels
        else:
            self.backbone = None
        if use_projection:
            self.input_feat_proj = nn.Linear(input_feat_size, hidden_size)
            self.LayerNorm_0 = nn.LayerNorm(hidden_size, eps=FLAX_LN_EPS)
        self.drop = nn.Dropout(dropout)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.backbone is not None and self.freeze_backbone:
            self.backbone.eval()
        return self

    def forward(self, obj_feats, flat_slot=None):
        if flat_slot is not None and self.backbone is None:
            raise ValueError(
                "flat_obj requires backbone='pointnet++' on the pc encoder "
                "(it ships raw (F, P, 6) point clouds)")
        if flat_slot is not None and self.training \
                and not self.freeze_backbone:
            raise ValueError(
                "flat_obj with an unfrozen PointNet++ backbone is not "
                "supported in training: BN batch stats over the flat "
                "layout differ from the padded layout; set "
                "freeze_backbone=True or unset flat_obj")
        if self.backbone is not None:
            if flat_slot is None:
                b, o = obj_feats.shape[:2]
                pts = obj_feats.reshape((b * o,) + obj_feats.shape[2:])
            else:
                pts = obj_feats
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not self.freeze_backbone):
                obj_feats = self.backbone(pts)
            if flat_slot is None:
                obj_feats = obj_feats.reshape(b, o, -1)
        if flat_slot is not None:
            obj_feats = torch.cat([obj_feats, obj_feats.new_zeros(
                (1,) + obj_feats.shape[1:])])[flat_slot.long()]
        if self.use_projection:
            obj_feats = self.LayerNorm_0(self.input_feat_proj(obj_feats))
        return self.drop(obj_feats)


class VoxelLevelEncoder(nn.Module):
    """Voxel-level Mask3D encoder (the JAX package's ``VoxelLevelEncoder``,
    registered as ``PCDMask3DEncoder``): Res16UNet -> mask features at the
    level-0 voxels plus a projected feature map per hlevel, on the
    rectangular (B, P_l) maps.  With ``pallas_conv`` the routed stride-1
    3^3 convs run kernel B1, as in the segment-level encoder.

    Returns (mask_feature (B, P0, hidden), [(B, P_l, hidden) per hlevel]).
    ``freeze_backbone`` runs the U-Net in eval mode and without gradient
    (JAX: batch statistics off, ``stop_gradient`` on its features)."""

    def __init__(self, hidden_size: int = 768,
                 hlevels: Sequence[int] = (0, 1, 2, 3),
                 dropout: float = 0.1, freeze_backbone: bool = False,
                 backbone_out_channels: int = 200, bn_momentum: float = 0.02,
                 conv1_kernel_size: int = 5, remat_policy: str = "full",
                 grad_mode: str = "native", pallas_conv: bool = False):
        super().__init__()
        self.hlevels = list(hlevels)
        self.freeze_backbone = freeze_backbone
        self.backbone = Res16UNet(out_channels=backbone_out_channels,
                                  conv1_kernel_size=conv1_kernel_size,
                                  pallas_conv=pallas_conv,
                                  bn_momentum=bn_momentum,
                                  grad_mode=grad_mode,
                                  remat_policy=remat_policy)
        p = self.backbone.feature_channels
        self.mask_proj = ProjectLN(p[4], hidden_size, dropout)
        for i, hlevel in enumerate(self.hlevels):
            self.add_module(f"scale_proj_{i}", ProjectLN(p[hlevel],
                                                         hidden_size,
                                                         dropout))

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_backbone:
            self.backbone.eval()
        return self

    def forward(self, voxel_feats: torch.Tensor,
                maps: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        # feature_maps are flat (B*P_l, C), [L4, L3, L2, L1, L0]
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_backbone):
            _, feature_maps = self.backbone(voxel_feats, maps)
        b, p0 = maps["valid_0"].shape
        mask_feat = self.mask_proj(feature_maps[4].reshape(b, p0, -1))
        multi_scale = []
        for i, hlevel in enumerate(self.hlevels):
            p_l = maps[f"valid_{4 - hlevel}"].shape[1]
            multi_scale.append(getattr(self, f"scale_proj_{i}")(
                feature_maps[hlevel].reshape(b, p_l, -1)))
        return mask_feat, multi_scale


class SemanticEncoder(nn.Module):
    """Label-embedding encoder with the prediction mixup curriculum (the
    JAX package's ``SemanticEncoder``).  The semantic embedding table
    (GloVe or CLIP label vectors) is the fixed buffer
    ``semantic_embedding`` (``buffers/semantic_embedding`` in the flax
    tree).  Returns (embeddings (..., hidden), the mean class logits)."""

    def __init__(self, hidden_size: int = 768, embed_dim: int = 300,
                 num_classes: int = 607, use_matmul_label: bool = False,
                 dropout: float = 0.1):
        super().__init__()
        self.use_matmul_label = use_matmul_label
        self.register_buffer("semantic_embedding",
                             torch.randn(num_classes, embed_dim) * 0.02)
        self.sem_emb_proj = ProjectLN(embed_dim, hidden_size, dropout)

    def forward(self, cls_logits_list: Sequence[torch.Tensor],
                obj_labels: Optional[torch.Tensor] = None,
                mixup_ratio=0.0):
        table = self.semantic_embedding
        logits = sum(cls_logits_list) / len(cls_logits_list)
        probs = torch.softmax(logits, -1).detach()
        if obj_labels is not None and mixup_ratio > 0:
            probs = mixup_predictions(probs, obj_labels, mixup_ratio)
        if self.use_matmul_label:
            embeds = probs @ table
        else:
            embeds = table[probs.argmax(-1)]
        return self.sem_emb_proj(embeds), logits


def mixup_predictions(probs: torch.Tensor, labels: torch.Tensor,
                      ratio) -> torch.Tensor:
    """Blend predicted class distributions with the one-hot ground truth
    at ``ratio`` (rows with a negative label keep their prediction)."""
    valid = labels >= 0
    onehot = nn.functional.one_hot(labels.clamp_min(0).long(),
                                   probs.shape[-1]).to(probs.dtype)
    mixed = torch.where(valid[..., None], onehot, probs)
    return probs * (1 - ratio) + mixed * ratio


def linear_decay_mixup_ratio(step, total_steps, stage1: float,
                             stage2: float) -> torch.Tensor:
    """Curriculum: 1 until ``stage1 * total_steps``, then a linear decay
    to 0 at ``stage2 * total_steps`` (an f32 scalar tensor)."""
    s1, s2 = stage1 * total_steps, stage2 * total_steps
    ratio = torch.as_tensor(s2 - step, dtype=torch.float32) / max(s2 - s1, 1)
    return ratio.clamp(0.0, 1.0)


def check_swin_window(model, pipe_cfg) -> None:
    """Raise ``ValueError`` unless a swin3d model's window
    (``voxel_enc.swin_window``) equals the pipeline's ``swin_window``: a
    mismatch would attend over arbitrary cell groups with the wrong bias
    table, silently wherever the pack length happens to divide the
    model's window volume.  Models without the swin backbone pass."""
    venc = getattr(model, "voxel_enc", None)
    if venc is None or getattr(venc, "backbone", None) != "swin3d":
        return
    win = int(getattr(pipe_cfg, "swin_window", 0) or 0)
    if win != venc.swin_window:
        raise ValueError(
            f"swin window mismatch: pipeline swin_window={win} but the "
            f"swin3d backbone expects {venc.swin_window} (model "
            f"voxel_encoder backbone.config.window): set them equal")
