"""Query3DUnified, stage-1 instance segmentation branch (PyTorch);
counterpart of ``pq3d_tpu/models/query3d.py`` for the
``("voxel", "mv", "pc")`` memories + ``("mask",)`` head with ``dim_loc=3``.

Data flow: query_locs -> Fourier positional queries; memories (voxel U-Net
segment features, mv/pc per-segment features) -> (feat, attend_mask, pos)
triples; the mask head bound with segment features; the unified query
decoder (num_blocks x num_layers, self-masking); a last mask prediction.
Consumes the batch dict of ``data/instseg_pipeline.collate`` as tensors.
``model.train()`` selects BatchNorm batch statistics and dropout (the JAX
``train=True``), ``model.eval()`` running statistics and no dropout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from pq3d_tpu_torch.device import resolve_device
from pq3d_tpu_torch.models import heads as heads_lib
from pq3d_tpu_torch.models.encoders import ObjectEncoder, SegVoxelEncoder
from pq3d_tpu_torch.models.layers import (FFNLayer, MaskedBatchNorm,
                                          MultiHeadAttention)
from pq3d_tpu_torch.models.posembed import (CoordinateEncoder,
                                            FourierPositionEncoding)
from pq3d_tpu_torch.models.query_encoder import QueryMaskEncoder
from pq3d_tpu_torch.models.sparse_unet import (DenseStemConv, Res16UNet,
                                               SparseConv,
                                               SparseConvTranspose)
from pq3d_tpu_torch.ops.pairwise import calc_pairwise_locs


@dataclasses.dataclass(frozen=True)
class UnifiedEncoderCfg:
    num_layers: int = 4
    num_blocks: int = 1
    num_attention_heads: int = 12
    structure: str = "parallel"
    spatial_selfattn: bool = True
    use_self_mask: bool = False


@dataclasses.dataclass(frozen=True)
class EncoderCfg:
    input_feat_size: int = 768
    dropout: float = 0.1


@dataclasses.dataclass(frozen=True)
class VoxelEncoderCfg:
    hlevels: Tuple[int, ...] = (0, 1, 2, 3)
    dropout: float = 0.1
    out_channels: int = 200
    bn_momentum: float = 0.02
    conv1_kernel_size: int = 5
    pallas_conv: bool = False    # route 3^3 convs to the z-run CUDA kernel


@dataclasses.dataclass(frozen=True)
class MaskHeadCfg:
    num_targets: int = 201
    filter_out_classes: Tuple[int, ...] = (0, 2)


class Query3DUnified(nn.Module):
    """Stage-1 instance segmentation model.  ``forward(batch)`` returns
    ``{"query", "predictions_class", "predictions_mask"}`` with one entry
    per decoder round plus the final prediction (last = final)."""

    def __init__(self, memories: Tuple[str, ...] = ("voxel", "mv", "pc"),
                 heads: Tuple[str, ...] = ("mask",), hidden_size: int = 768,
                 dim_loc: int = 3, spatial_dim: int = 5,
                 pairwise_rel_type: str = "center",
                 unified: UnifiedEncoderCfg = UnifiedEncoderCfg(),
                 mv_enc: EncoderCfg = EncoderCfg(),
                 pc_enc: EncoderCfg = EncoderCfg(),
                 voxel_enc: VoxelEncoderCfg = VoxelEncoderCfg(),
                 mask_head_cfg: MaskHeadCfg = MaskHeadCfg()):
        super().__init__()
        if tuple(heads) != ("mask",) or dim_loc != 3 \
                or pairwise_rel_type != "center" \
                or not set(memories) <= {"voxel", "mv", "pc"}:
            raise NotImplementedError(
                "the port serves the stage-1 instseg branch: memories from "
                "(voxel, mv, pc), heads ('mask',), dim_loc 3, 'center' "
                "pairwise relations")
        self.memories = tuple(memories)
        self.hidden_size = hidden_size
        self.spatial_dim = spatial_dim
        self.unified = unified
        self.coord_encoder = CoordinateEncoder(hidden_size)
        if "mv" in memories:
            self.mv_encoder = ObjectEncoder(mv_enc.input_feat_size,
                                            hidden_size, mv_enc.dropout)
        if "pc" in memories:
            self.pc_encoder = ObjectEncoder(pc_enc.input_feat_size,
                                            hidden_size, pc_enc.dropout)
        if "voxel" in memories:
            self.voxel_encoder = SegVoxelEncoder(
                hidden_size=hidden_size, hlevels=voxel_enc.hlevels,
                backbone_out_channels=voxel_enc.out_channels,
                conv1_kernel_size=voxel_enc.conv1_kernel_size,
                pallas_conv=voxel_enc.pallas_conv,
                dropout=voxel_enc.dropout,
                bn_momentum=voxel_enc.bn_momentum)
        self.mask_head = heads_lib.MaskHeadSegLevel(
            hidden_size, mask_head_cfg.num_targets,
            num_memories=len(self.memories),
            filter_out_classes=mask_head_cfg.filter_out_classes)
        self.unified_encoder = QueryMaskEncoder(
            hidden_size=hidden_size,
            num_attention_heads=unified.num_attention_heads,
            num_layers=unified.num_layers, num_blocks=unified.num_blocks,
            memories=self.memories, structure=unified.structure,
            spatial_selfattn=unified.spatial_selfattn,
            use_self_mask=unified.use_self_mask)

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        coord_min, coord_max = batch["coord_min"], batch["coord_max"]
        rng = (coord_min, coord_max)
        query_locs = batch["query_locs"][..., :3]
        query_valid = batch["query_pad_masks"]
        query_pos = self.coord_encoder(query_locs, rng)
        inputs: Dict[str, Tuple] = {
            "query": (torch.zeros_like(query_pos), query_valid, query_pos)}
        fts_locs = batch["seg_center"]
        fts_pos = self.coord_encoder(fts_locs[..., :3], rng)
        seg_valid = batch["seg_pad_masks"]

        for mem in self.memories:
            if mem == "mv":
                inputs[mem] = (self.mv_encoder(batch["mv_seg_fts"]),
                               batch["mv_seg_pad_masks"], fts_pos)
            elif mem == "pc":
                inputs[mem] = (self.pc_encoder(batch["pc_seg_fts"]),
                               batch["pc_seg_pad_masks"], fts_pos)
            else:
                scales = self.voxel_encoder(
                    batch["voxel_feats"], batch["maps"],
                    batch["voxel2segment"], max_seg=fts_locs.shape[1])
                inputs[mem] = (scales, seg_valid, fts_pos)

        seg_fts_for_match = []
        for mem in self.memories:
            feat, mask, _ = inputs[mem]
            if isinstance(feat, (list, tuple)):
                feat = feat[-1]    # final voxel scale for matching
            seg_fts_for_match.append((feat, mask))

        def mask_head(query):
            return self.mask_head(query, seg_fts_for_match, seg_valid)

        pairwise_locs = None
        if self.unified.spatial_selfattn:
            pairwise_locs = calc_pairwise_locs(query_locs,
                                               spatial_dim=self.spatial_dim)
        query, pred_cls, pred_mask = self.unified_encoder(
            inputs, pairwise_locs, mask_head=mask_head)
        cls_logits, mask_logits, _ = mask_head(query)
        return {"query": query,
                "predictions_class": pred_cls + [cls_logits],
                "predictions_mask": pred_mask + [mask_logits]}


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator`` (CPU), with the JAX package's init
    families: normal(0.02) for dense layers, Xavier-uniform inside attention
    and FFN blocks, He-normal (fan-in) for sparse/dense convs and the
    backbone's 1x1 layers, N(0, 1) for the Fourier projection; norms start
    at identity."""
    def normal_(t, std):
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=generator) * std)

    def xavier_(t):
        fan_out, fan_in = t.shape
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        with torch.no_grad():
            t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1)
                    * bound)

    def linears(scope_types):
        return {id(lin) for scope in model.modules()
                if isinstance(scope, scope_types)
                for lin in scope.modules() if isinstance(lin, nn.Linear)}

    he_linear = linears(Res16UNet)              # final, downsample_conv
    xavier_linear = linears((MultiHeadAttention, FFNLayer))
    for mod in model.modules():
        if isinstance(mod, (SparseConv, SparseConvTranspose, DenseStemConv)):
            k, cin, _ = mod.kernel.shape
            normal_(mod.kernel, math.sqrt(2.0 / (k * cin)))
        elif isinstance(mod, FourierPositionEncoding):
            normal_(mod.gauss_B, mod.gauss_scale)
        elif isinstance(mod, MaskedBatchNorm):
            with torch.no_grad():
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
        elif isinstance(mod, nn.LayerNorm):
            with torch.no_grad():
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            if id(mod) in he_linear:
                normal_(mod.weight, math.sqrt(2.0 / mod.in_features))
            elif id(mod) in xavier_linear:
                xavier_(mod.weight)
            else:
                normal_(mod.weight, 0.02)
            if mod.bias is not None:
                with torch.no_grad():
                    mod.bias.zero_()


def build_model(cfg: Dict[str, Any], device="cuda", seed: int = 0
                ) -> Query3DUnified:
    """Build the stage-1 model from a resolved config dict (the YAML
    schema: ``cfg["model"]`` as in configs/instseg_sceneverse.yaml, dropout
    rates included), with random weights drawn from
    ``torch.Generator().manual_seed(seed)``, in eval mode on ``device``
    (raises without CUDA unless device="cpu").  Training runs the JAX
    model's ``grad_mode='scatter_free'`` with ``remat_policy='none'``, the
    defaults there; other values are not ported."""
    dev = resolve_device(device)
    m = cfg["model"]
    ue = m["unified_encoder"]["args"]
    va = m["voxel_encoder"]["args"]
    bk = va.get("backbone_kwargs") or {}
    bk_cfg = bk.get("config") or {}
    mh = m["mask_head"]["args"]
    if va.get("grad_mode", "scatter_free") != "scatter_free" \
            or va.get("remat_policy", "none") != "none":
        raise NotImplementedError(
            "the port trains with grad_mode='scatter_free' and "
            "remat_policy='none' only")

    def enc_cfg(name):
        a = m[name]["args"]
        return EncoderCfg(a.get("input_feat_size", 768),
                          a.get("dropout", 0.1))
    model = Query3DUnified(
        memories=tuple(m["memories"]), heads=tuple(m["heads"]),
        hidden_size=m["hidden_size"], dim_loc=m["obj_loc"]["dim_loc"],
        spatial_dim=m["obj_loc"]["spatial_dim"],
        pairwise_rel_type=m["obj_loc"]["pairwise_rel_type"],
        unified=UnifiedEncoderCfg(
            num_layers=ue["num_layers"],
            num_blocks=ue.get("num_blocks", 1),
            num_attention_heads=ue["num_attention_heads"],
            structure=ue["structure"],
            spatial_selfattn=ue.get("spatial_selfattn", True),
            use_self_mask=ue.get("use_self_mask", False)),
        mv_enc=enc_cfg("mv_encoder"),
        pc_enc=enc_cfg("pc_encoder"),
        voxel_enc=VoxelEncoderCfg(
            hlevels=tuple(va.get("hlevels", (0, 1, 2, 3))),
            dropout=va.get("dropout", 0.1),
            out_channels=bk.get("out_channels", 200),
            bn_momentum=bk_cfg.get("bn_momentum", 0.02),
            conv1_kernel_size=bk_cfg.get("conv1_kernel_size", 5),
            pallas_conv=va.get("pallas_conv", False)),
        mask_head_cfg=MaskHeadCfg(
            num_targets=mh["num_targets"],
            filter_out_classes=tuple(mh.get("filter_out_classes") or ())))
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval().to(dev)
