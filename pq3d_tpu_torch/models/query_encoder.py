"""Promptable query decoder (PyTorch); counterpart of
``pq3d_tpu/models/query_encoder.py``: ``num_blocks`` x ``num_layers``
rounds of [mask prediction -> masked cross-attention over memories ->
spatial self-attention -> FFN], parallel memory structure.

Memories are a dict name -> (feat, attend_mask, pos) with True = attend.
With ``use_self_mask`` the thresholded mask logits of each round become
the next round's cross-attention masks.  Every sublayer drops out at
``dropout`` (0.1, fixed in the JAX layer) in train mode.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from pq3d_tpu_torch.models.layers import (CrossAttentionLayer, FFNLayer,
                                          SelfAttentionLayer,
                                          SpatialSelfAttentionLayer)

Memory = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


class QueryEncoderLayer(nn.Module):
    """One decoder layer, parallel structure: the per-memory cross
    attentions see the same query and their updates are averaged."""

    def __init__(self, d_model: int, n_head: int, memories: Sequence[str],
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 spatial_selfattn: bool = False,
                 structure: str = "parallel"):
        super().__init__()
        if structure != "parallel":
            raise NotImplementedError(
                f"query encoder structure {structure!r} is not ported")
        self.memories = list(memories)
        self.spatial_selfattn = spatial_selfattn
        if spatial_selfattn:
            self.self_attn = SpatialSelfAttentionLayer(d_model, n_head,
                                                       dropout=dropout)
        else:
            self.self_attn = SelfAttentionLayer(d_model, n_head, dropout)
        for m in self.memories:
            self.add_module(f"cross_attns_{m}",
                            CrossAttentionLayer(d_model, n_head, dropout))
        self.ffn = FFNLayer(d_model, dim_feedforward, dropout)

    def forward(self, query: torch.Tensor, inputs: Dict[str, Memory],
                pairwise_locs: Optional[torch.Tensor] = None):
        _, query_valid, query_pos = inputs["query"]
        updates = [getattr(self, f"cross_attns_{m}")(
            query, inputs[m][0], attend_mask=inputs[m][1],
            query_pos=query_pos, pos=inputs[m][2]) for m in self.memories]
        query = torch.stack(updates, 1).mean(1)
        if self.spatial_selfattn:
            query = self.self_attn(query, pairwise_locs,
                                   key_attend_mask=query_valid,
                                   query_pos=query_pos)
        else:
            query = self.self_attn(query, attend_mask=query_valid,
                                   query_pos=query_pos)
        return self.ffn(query)


class QueryMaskEncoder(nn.Module):
    """Iterative mask-guided decoder.  ``mask_head`` is a callable
    ``query -> (cls_logits, mask_logits, attend_mask)``; rounds are
    unrolled (num_blocks x num_layers is small and static)."""

    def __init__(self, hidden_size: int = 768, num_attention_heads: int = 12,
                 num_layers: int = 4, num_blocks: int = 1,
                 memories: Sequence[str] = ("voxel", "mv", "pc"),
                 structure: str = "parallel", spatial_selfattn: bool = True,
                 use_self_mask: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.memories = list(memories)
        self.use_self_mask = use_self_mask
        for i in range(num_layers):
            self.add_module(f"layer{i}", QueryEncoderLayer(
                hidden_size, num_attention_heads, self.memories,
                spatial_selfattn=spatial_selfattn, structure=structure))

    def forward(self, inputs: Dict[str, Memory],
                pairwise_locs: Optional[torch.Tensor] = None,
                mask_head: Optional[Callable] = None):
        predictions_class: List[torch.Tensor] = []
        predictions_mask: List[torch.Tensor] = []
        query = inputs["query"][0]
        voxel_feat = inputs.get("voxel", (None,))[0]
        inputs = dict(inputs)
        for _ in range(self.num_blocks):
            for i in range(self.num_layers):
                if mask_head is not None:
                    cls_logits, mask_logits, attend = mask_head(query)
                    predictions_class.append(cls_logits)
                    predictions_mask.append(mask_logits)
                    if self.use_self_mask:
                        # unblock queries that can attend nowhere
                        none_ok = ~attend.any(-1, keepdim=True)
                        attend = attend | none_ok
                        for m in self.memories:
                            if m in ("query", "prompt") or m not in inputs:
                                continue
                            feat, _, pos = inputs[m]
                            inputs[m] = (feat, attend, pos)
                if isinstance(voxel_feat, (list, tuple)):
                    _, mask, pos = inputs["voxel"]
                    inputs["voxel"] = (voxel_feat[i], mask, pos)
                query = getattr(self, f"layer{i}")(query, inputs,
                                                   pairwise_locs)
        return query, predictions_class, predictions_mask
