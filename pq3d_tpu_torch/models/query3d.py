"""Query3DUnified (PyTorch); counterpart of ``pq3d_tpu/models/query3d.py``.

Two branches of the JAX model are ported:

- stage 1, instance segmentation: memories from (voxel, mv, pc), the
  ``mask`` head, ``dim_loc`` 3 (Fourier positional queries), the voxel
  U-Net's segment features, self-masking rounds;
- stage 2, the unified tasks: memories from (mv, pc, voxel, prompt), the
  ``ground`` and ``generation`` heads, ``dim_loc`` 6 (coord + box Linear/LN
  embeddings, the box embedding added to the memory positions twice, as
  the JAX model does), PointNet++ over the object clouds, offline voxel
  features, and the prompt encoded by type: TXT through the CLIP text
  encoder, LOC through the location embedding.

With ``use_offline_attn_mask`` (the GT-query stage-1 variant) every call
of the mask head returns the batch's ``offline_attn_mask`` as its attend
mask, and a batch without one raises ``ValueError``.

Data flow: query_locs -> positional queries; memories -> (feat,
attend_mask, pos) triples; the mask head bound with segment features (when
there is one); the unified query decoder; the task heads.  Consumes the
batch dict of ``data/instseg_pipeline.collate`` or
``data/unified_pipeline.collate_unified`` as tensors.  ``model.train()``
selects BatchNorm batch statistics and dropout (the JAX ``train=True``),
``model.eval()`` running statistics and no dropout.  Not ported (they
raise): image prompts, the ``qa`` head, a BERT text encoder.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pq3d_tpu_torch.data.unified_pipeline import PROMPT_TXT
from pq3d_tpu_torch.device import resolve_device
from pq3d_tpu_torch.models import heads as heads_lib
from pq3d_tpu_torch.models.clip_text import CLIPTextEncoder, CLIPTextTower
from pq3d_tpu_torch.models.encoders import ObjectEncoder, SegVoxelEncoder
from pq3d_tpu_torch.models.generation import T5GenerationHead
from pq3d_tpu_torch.models.layers import (FLAX_LN_EPS, BatchNorm, FFNLayer,
                                          MaskedBatchNorm,
                                          MultiHeadAttention)
from pq3d_tpu_torch.models.pointnet import PointNetPP
from pq3d_tpu_torch.models.posembed import (CoordinateEncoder,
                                            FourierPositionEncoding)
from pq3d_tpu_torch.models.query_encoder import QueryMaskEncoder
from pq3d_tpu_torch.models.sparse_unet import (DenseStemConv, Res16UNet,
                                               SparseConv,
                                               SparseConvTranspose)
from pq3d_tpu_torch.models.t5 import RMSNorm, T5Decoder
from pq3d_tpu_torch.ops.pairwise import calc_pairwise_locs


@dataclasses.dataclass(frozen=True)
class UnifiedEncoderCfg:
    num_layers: int = 4
    num_blocks: int = 1
    num_attention_heads: int = 12
    structure: str = "parallel"
    spatial_selfattn: bool = True
    use_self_mask: bool = False
    memory_dropout: float = 0.0
    drop_memories_test: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class EncoderCfg:
    input_feat_size: int = 768
    dropout: float = 0.1
    use_projection: bool = True
    backbone: str = "none"
    freeze_backbone: bool = False


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


@dataclasses.dataclass(frozen=True)
class GroundHeadCfg:
    hidden_size: int = 384
    dropout: float = 0.3


@dataclasses.dataclass(frozen=True)
class TxtEncoderCfg:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12


@dataclasses.dataclass(frozen=True)
class GenerationHeadCfg:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    max_new_tokens: int = 50
    # stop decoding once every row has emitted EOS (token-exact with the
    # fixed-length loop)
    early_exit: bool = False


class Query3DUnified(nn.Module):
    """``forward(batch)`` returns ``{"query"}`` plus, per head: ``mask`` ->
    ``predictions_class`` / ``predictions_mask`` (one entry per decoder
    round plus the final prediction, last = final); ``ground`` ->
    ``ground_logits`` (= ``og3d_logits``); ``generation`` -> teacher-forced
    ``generation_logits`` when the batch carries ``response``, and in eval
    mode the greedy ``generation_tokens``."""

    def __init__(self, memories: Tuple[str, ...] = ("voxel", "mv", "pc"),
                 heads: Tuple[str, ...] = ("mask",), hidden_size: int = 768,
                 dim_loc: int = 3, spatial_dim: int = 5,
                 pairwise_rel_type: str = "center",
                 use_offline_voxel_fts: bool = False,
                 use_offline_attn_mask: bool = False,
                 skip_query_encoder_mask_pred: bool = False,
                 unified: UnifiedEncoderCfg = UnifiedEncoderCfg(),
                 mv_enc: EncoderCfg = EncoderCfg(),
                 pc_enc: EncoderCfg = EncoderCfg(),
                 voxel_obj_enc: EncoderCfg = EncoderCfg(128),
                 voxel_enc: VoxelEncoderCfg = VoxelEncoderCfg(),
                 mask_head_cfg: Optional[MaskHeadCfg] = MaskHeadCfg(),
                 ground_head_cfg: GroundHeadCfg = GroundHeadCfg(),
                 generation_head_cfg: GenerationHeadCfg = GenerationHeadCfg(),
                 txt_cfg: TxtEncoderCfg = TxtEncoderCfg()):
        super().__init__()
        if not set(heads) <= {"mask", "ground", "generation"} \
                or dim_loc not in (3, 6) \
                or pairwise_rel_type != "center" \
                or not set(memories) <= {"voxel", "mv", "pc", "prompt"}:
            raise NotImplementedError(
                "the port runs memories from (voxel, mv, pc, prompt), heads "
                "from (mask, ground, generation), dim_loc 3 or 6 and "
                "'center' pairwise relations")
        if "mask" in heads and mask_head_cfg is None:
            raise ValueError("the mask head needs mask_head_cfg")
        self.memories = tuple(memories)
        self.heads = tuple(heads)
        self.hidden_size = hidden_size
        self.dim_loc = dim_loc
        self.spatial_dim = spatial_dim
        self.use_offline_voxel_fts = use_offline_voxel_fts
        self.use_offline_attn_mask = use_offline_attn_mask
        self.skip_query_encoder_mask_pred = skip_query_encoder_mask_pred
        self.unified = unified
        if dim_loc > 3:
            self.coord_dense = nn.Linear(3, hidden_size)
            self.coord_ln = nn.LayerNorm(hidden_size, eps=FLAX_LN_EPS)
            self.box_dense = nn.Linear(3, hidden_size)
            self.box_ln = nn.LayerNorm(hidden_size, eps=FLAX_LN_EPS)
        else:
            self.coord_encoder = CoordinateEncoder(hidden_size)

        def obj_encoder(c: EncoderCfg):
            return ObjectEncoder(c.input_feat_size, hidden_size, c.dropout,
                                 use_projection=c.use_projection,
                                 backbone=c.backbone,
                                 freeze_backbone=c.freeze_backbone)
        if "mv" in memories:
            self.mv_encoder = obj_encoder(mv_enc)
        if "pc" in memories:
            self.pc_encoder = obj_encoder(pc_enc)
        if "voxel" in memories:
            if use_offline_voxel_fts:
                self.voxel_encoder = obj_encoder(voxel_obj_enc)
            else:
                self.voxel_encoder = SegVoxelEncoder(
                    hidden_size=hidden_size, hlevels=voxel_enc.hlevels,
                    backbone_out_channels=voxel_enc.out_channels,
                    conv1_kernel_size=voxel_enc.conv1_kernel_size,
                    pallas_conv=voxel_enc.pallas_conv,
                    dropout=voxel_enc.dropout,
                    bn_momentum=voxel_enc.bn_momentum)
        if "prompt" in memories:
            self.txt_encoder = CLIPTextEncoder(
                output_dim=hidden_size, vocab_size=txt_cfg.vocab_size,
                width=txt_cfg.width, tower_heads=txt_cfg.heads,
                tower_layers=txt_cfg.layers)
        self.match_memories = [m for m in self.memories
                               if m in ("voxel", "mv", "pc")]
        if "mask" in heads:
            self.mask_head = heads_lib.MaskHeadSegLevel(
                hidden_size, mask_head_cfg.num_targets,
                num_memories=len(self.match_memories),
                filter_out_classes=mask_head_cfg.filter_out_classes)
        self.unified_encoder = QueryMaskEncoder(
            hidden_size=hidden_size,
            num_attention_heads=unified.num_attention_heads,
            num_layers=unified.num_layers, num_blocks=unified.num_blocks,
            memories=self.memories, structure=unified.structure,
            spatial_selfattn=unified.spatial_selfattn,
            use_self_mask=unified.use_self_mask,
            memory_dropout=unified.memory_dropout,
            drop_memories_test=unified.drop_memories_test)
        if "ground" in heads:
            self.ground_head = heads_lib.GroundHead(
                hidden_size, ground_head_cfg.hidden_size,
                ground_head_cfg.dropout)
        if "generation" in heads:
            self.generation_head = T5GenerationHead(hidden_size,
                                                    generation_head_cfg)

    def _coord(self, xyz):
        return self.coord_ln(self.coord_dense(xyz))

    def _box(self, whl):
        return self.box_ln(self.box_dense(whl))

    def _loc_embed(self, locs, rng):
        """Location -> hidden embedding: Fourier for dim_loc 3, the coord
        and box Linear/LN pairs for dim_loc 6."""
        if self.dim_loc > 3:
            return self._coord(locs[..., :3]) + self._box(locs[..., 3:6])
        return self.coord_encoder(locs[..., :3], rng)

    def _encode_prompt(self, batch, rng):
        """Route each prompt by type: TXT rows through the text encoder,
        the others (LOC; image prompts raise) through the location
        embedding of the box that the first ``dim_loc`` floats hold (one
        valid token)."""
        if "prompt_img_fts" in batch:
            raise NotImplementedError("image prompts are not ported")
        prompt = batch["prompt"]                   # (B, L) float
        valid = batch["prompt_pad_masks"]          # (B, L) True = valid
        is_txt = (batch["prompt_type"] == PROMPT_TXT)[:, None]
        # LOC rows hold coordinates, not token ids; their text features are
        # discarded below, so they read token 0
        ids = torch.where(is_txt, prompt.long(), 0)
        txt_feat = self.txt_encoder(ids, valid)
        loc_feat = self._loc_embed(prompt[:, None, :self.dim_loc], rng)
        loc_feat = F.pad(loc_feat, (0, 0, 0, prompt.shape[1] - 1))
        loc_valid = torch.zeros_like(valid)
        loc_valid[:, 0] = True
        feat = torch.where(is_txt[..., None], txt_feat, loc_feat)
        return feat, torch.where(is_txt, valid, loc_valid)

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        rng = (batch.get("coord_min"), batch.get("coord_max"))
        query_locs = batch["query_locs"][..., :self.dim_loc]
        query_valid = batch["query_pad_masks"]
        query_pos = self._loc_embed(query_locs, rng)
        inputs: Dict[str, Tuple] = {
            "query": (torch.zeros_like(query_pos), query_valid, query_pos)}
        fts_locs = batch["seg_center"]
        fts_pos = self._loc_embed(fts_locs[..., :self.dim_loc], rng)
        if self.dim_loc > 3:
            # the box embedding is added to the memory positions twice:
            # once in the coord + box sum, then again (the JAX model's and
            # its checkpoints' convention)
            fts_pos = fts_pos + self._box(fts_locs[..., 3:6])
        seg_valid = batch["seg_pad_masks"]

        for mem in self.memories:
            if mem == "mv":
                inputs[mem] = (self.mv_encoder(batch["mv_seg_fts"]),
                               batch["mv_seg_pad_masks"], fts_pos)
            elif mem == "pc":
                inputs[mem] = (self.pc_encoder(batch["pc_seg_fts"]),
                               batch["pc_seg_pad_masks"], fts_pos)
            elif mem == "voxel" and self.use_offline_voxel_fts:
                inputs[mem] = (self.voxel_encoder(batch["voxel_seg_fts"]),
                               batch["voxel_seg_pad_masks"], fts_pos)
            elif mem == "voxel":
                scales = self.voxel_encoder(
                    batch["voxel_feats"], batch["maps"],
                    batch["voxel2segment"], max_seg=fts_locs.shape[1])
                inputs[mem] = (scales, seg_valid, fts_pos)
            else:
                inputs[mem] = self._encode_prompt(batch, rng) + (None,)

        offline_attn = None
        if self.use_offline_attn_mask:
            offline_attn = batch.get("offline_attn_mask")
            if offline_attn is None:
                # falling back to predicted self-masks would quietly run
                # another model than the configured one
                raise ValueError(
                    "use_offline_attn_mask=True but the batch has no "
                    "'offline_attn_mask' — set data.instseg_options."
                    "offline_mask_source='gt' (or unset the model flag)")
        mask_head = None
        if "mask" in self.heads:
            seg_fts_for_match = []
            for mem in self.match_memories:
                feat, mask, _ = inputs[mem]
                if isinstance(feat, (list, tuple)):
                    feat = feat[-1]    # final voxel scale for matching
                seg_fts_for_match.append((feat, mask))

            def mask_head(query, skip=self.skip_query_encoder_mask_pred):
                return self.mask_head(query, seg_fts_for_match, seg_valid,
                                      offline_attn_masks=offline_attn,
                                      skip_prediction=skip)

        pairwise_locs = None
        if self.unified.spatial_selfattn:
            pairwise_locs = calc_pairwise_locs(query_locs[..., :3],
                                               spatial_dim=self.spatial_dim)
        query, pred_cls, pred_mask = self.unified_encoder(
            inputs, pairwise_locs, mask_head=mask_head)
        out: Dict[str, Any] = {"query": query}
        if "mask" in self.heads:
            cls_logits, mask_logits, _ = mask_head(query, skip=False)
            out["predictions_class"] = pred_cls + [cls_logits]
            out["predictions_mask"] = pred_mask + [mask_logits]
        if "ground" in self.heads:
            out["ground_logits"] = out["og3d_logits"] = self.ground_head(
                query, query_valid)
        if "generation" in self.heads:
            response = batch.get("response")
            if response is not None:
                out["generation_logits"] = self.generation_head(
                    query, query_valid, labels=response)
            if not self.training:
                out["generation_tokens"] = self.generation_head(
                    query, query_valid)
        return out


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator`` (CPU), with the JAX package's init
    families: normal(0.02) for dense layers, Xavier-uniform inside attention
    and FFN blocks, He-normal (fan-in) for sparse/dense convs, the U-Net's
    1x1 layers and PointNet++'s shared MLPs, LeCun-normal (fan-in) for the
    CLIP tower's and the T5 decoder's layers, N(0, 1) for the Fourier
    projection and T5's embedding, N(0, 1/width) for the other embeddings,
    N(0, 0.01^2) for CLIP's positions, N(0, 0.02^2) for its text
    projection; norms start at identity."""
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

    he_linear = linears((Res16UNet, PointNetPP))
    xavier_linear = linears((MultiHeadAttention, FFNLayer))
    lecun_linear = linears((CLIPTextTower, T5Decoder))
    t5_embed = {id(m.embed) for m in model.modules()
                if isinstance(m, T5Decoder)}
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
        elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
            with torch.no_grad():
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, RMSNorm):
            with torch.no_grad():
                mod.weight.fill_(1.0)
        elif isinstance(mod, CLIPTextTower):
            normal_(mod.positional_embedding, 0.01)
            normal_(mod.text_projection, 0.02)
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 1.0 if id(mod) in t5_embed
                    else mod.embedding_dim ** -0.5)
        elif isinstance(mod, nn.Linear):
            if id(mod) in he_linear:
                normal_(mod.weight, math.sqrt(2.0 / mod.in_features))
            elif id(mod) in lecun_linear:
                normal_(mod.weight, math.sqrt(1.0 / mod.in_features))
            elif id(mod) in xavier_linear:
                xavier_(mod.weight)
            else:
                normal_(mod.weight, 0.02)
            if mod.bias is not None:
                with torch.no_grad():
                    mod.bias.zero_()


def build_model(cfg: Dict[str, Any], device="cuda", seed: int = 0
                ) -> Query3DUnified:
    """Build the model from a resolved config dict (the YAML schema:
    ``cfg["model"]`` as in configs/instseg_sceneverse.yaml or
    unified_tasks_sceneverse.yaml, dropout rates included), with random
    weights drawn from ``torch.Generator().manual_seed(seed)``, in eval
    mode on ``device`` (raises without CUDA unless device="cpu").  Stage-1
    training runs the JAX model's ``grad_mode='scatter_free'`` with
    ``remat_policy='none'``, the defaults there; other values, a BERT text
    encoder, a bf16, trainable or unprojected text tower, the ``attention``
    text projection and an unprojected generation head are not ported
    (they raise)."""
    dev = resolve_device(device)
    m = cfg["model"]
    ue = m["unified_encoder"]["args"]
    use_offline_voxel = m.get("use_offline_voxel_fts", False)

    def enc_cfg(node, default_in=768):
        if node is None:
            return EncoderCfg(default_in)
        a = node["args"]
        return EncoderCfg(a.get("input_feat_size", default_in),
                          a.get("dropout", 0.1),
                          use_projection=a.get("use_projection", True),
                          backbone=a.get("backbone", "none"),
                          freeze_backbone=a.get("freeze_backbone", False))

    voxel_node = m.get("voxel_encoder")
    voxel_enc = VoxelEncoderCfg()
    voxel_obj_enc = EncoderCfg(128)
    if use_offline_voxel or voxel_node is None:
        voxel_obj_enc = enc_cfg(voxel_node, default_in=128)
    else:
        va = voxel_node["args"]
        bk = va.get("backbone_kwargs") or {}
        bk_cfg = bk.get("config") or {}
        if va.get("grad_mode", "scatter_free") != "scatter_free" \
                or va.get("remat_policy", "none") != "none":
            raise NotImplementedError(
                "the port trains with grad_mode='scatter_free' and "
                "remat_policy='none' only")
        voxel_enc = VoxelEncoderCfg(
            hlevels=tuple(va.get("hlevels", (0, 1, 2, 3))),
            dropout=va.get("dropout", 0.1),
            out_channels=bk.get("out_channels", 200),
            bn_momentum=bk_cfg.get("bn_momentum", 0.02),
            conv1_kernel_size=bk_cfg.get("conv1_kernel_size", 5),
            pallas_conv=va.get("pallas_conv", False))

    mask_head_cfg = None
    if m.get("mask_head") is not None:
        mh = m["mask_head"]["args"]
        mask_head_cfg = MaskHeadCfg(
            num_targets=mh["num_targets"],
            filter_out_classes=tuple(mh.get("filter_out_classes") or ()))
    gh = GroundHeadCfg()
    if m.get("ground_head") is not None:
        a = m["ground_head"]["args"]
        gh = GroundHeadCfg(a.get("hidden_size", 384), a.get("dropout", 0.3))
    gen = GenerationHeadCfg()
    if m.get("generation_head") is not None:
        a = m["generation_head"]["args"]
        if not a.get("use_projection", True) or a.get("two_phase"):
            raise NotImplementedError(
                "the port's generation head projects the queries "
                "(use_projection: True) and decodes in the forward "
                "(two_phase: False)")
        gen = GenerationHeadCfg(
            vocab_size=a.get("vocab_size", 32128),
            d_model=a.get("d_model", 512), d_kv=a.get("d_kv", 64),
            d_ff=a.get("d_ff", 2048), num_layers=a.get("num_layers", 6),
            num_heads=a.get("num_heads", 8),
            max_new_tokens=a.get("max_new_tokens", 50),
            early_exit=a.get("early_exit", False))
    txt = TxtEncoderCfg()
    if m.get("txt_encoder") is not None:
        ta = m["txt_encoder"].get("args") or {}
        tower = m.get("txt_tower") or {}
        if "BERT" in m["txt_encoder"].get("name", "") \
                or ta.get("compute_dtype", "float32") != "float32" \
                or not ta.get("use_projection", True) \
                or ta.get("projection_type", "mlp") != "mlp" \
                or not ta.get("freeze_backbone", True):
            raise NotImplementedError(
                "the port's text encoder is the frozen f32 CLIP tower with "
                "the mlp projection")
        txt = TxtEncoderCfg(
            vocab_size=tower.get("vocab_size", 49408),
            width=tower.get("width", 768), layers=tower.get("layers", 12),
            heads=tower.get("heads", 12))

    model = Query3DUnified(
        memories=tuple(m["memories"]), heads=tuple(m["heads"]),
        hidden_size=m["hidden_size"], dim_loc=m["obj_loc"]["dim_loc"],
        spatial_dim=m["obj_loc"]["spatial_dim"],
        pairwise_rel_type=m["obj_loc"]["pairwise_rel_type"],
        use_offline_voxel_fts=use_offline_voxel,
        use_offline_attn_mask=m.get("use_offline_attn_mask", False),
        skip_query_encoder_mask_pred=m.get("skip_query_encoder_mask_pred",
                                           False),
        unified=UnifiedEncoderCfg(
            num_layers=ue["num_layers"],
            num_blocks=ue.get("num_blocks", 1),
            num_attention_heads=ue["num_attention_heads"],
            structure=ue["structure"],
            spatial_selfattn=ue.get("spatial_selfattn", True),
            use_self_mask=ue.get("use_self_mask", False),
            memory_dropout=ue.get("memory_dropout", 0.0),
            drop_memories_test=tuple(ue.get("drop_memories_test") or ())),
        mv_enc=enc_cfg(m.get("mv_encoder")),
        pc_enc=enc_cfg(m.get("pc_encoder")),
        voxel_obj_enc=voxel_obj_enc, voxel_enc=voxel_enc,
        mask_head_cfg=mask_head_cfg, ground_head_cfg=gh,
        generation_head_cfg=gen, txt_cfg=txt)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval().to(dev)
