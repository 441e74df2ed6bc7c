"""Promptable query decoder (PyTorch); counterpart of
``pq3d_tpu/models/query_encoder.py``: ``num_blocks`` x ``num_layers``
rounds of [mask prediction -> masked cross-attention over memories ->
(spatial) self-attention -> FFN].  Memory structures: ``parallel`` (the
cross attentions see the same query, their updates averaged),
``sequential`` (one after another) and ``mixed`` (the scene memories in
parallel, then the prompt).  ``drop_memories_test`` leaves the named
memories out in eval mode.  In train mode ``memory_dropout`` drops each
parallel memory of each sample with that probability, keeps at least one,
and averages the survivors; its uniform draws come from the generator
that ``set_memory_generator`` gives (the trainer seeds it from
``rng_seed``), never from the global RNG.  ``gate``: ``gate =
sigmoid(gate_proj(prompt cross-attention of the query))`` mixes the query
with the parallel update over the scene memories, ``(1 - gate) * query +
gate * update``; as in the JAX layer, that update reads every scene
memory of the layer, ``drop_memories_test`` notwithstanding.

``QueryEncoder`` is the non-mask decoder: the same layers with no mask
prediction, after whole-memory sample dropout (its class docstring).

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


def memory_keep_mean(stacked: torch.Tensor, u: torch.Tensor,
                     p: float) -> torch.Tensor:
    """Memory dropout of the parallel cross-attention updates ``stacked``
    (B, M, Q, D): per sample keep memory m where ``u[b, m] > p``, keep all
    of a sample that would keep none (at least one survivor), and average
    the kept updates (sum over kept / number kept)."""
    keep = u > p
    keep = keep | (keep.sum(1, keepdim=True) == 0)
    n_keep = keep.sum(1).to(stacked.dtype)
    w = keep[..., None, None].to(stacked.dtype)
    return (stacked * w).sum(1) / n_keep[:, None, None]


class QueryEncoderLayer(nn.Module):
    """One decoder layer: per-memory cross attention in the given
    structure, then self-attention and FFN (``activation``: the FFN's,
    ``layers.get_activation``)."""

    def __init__(self, d_model: int, n_head: int, memories: Sequence[str],
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 spatial_selfattn: bool = False,
                 structure: str = "parallel", memory_dropout: float = 0.0,
                 drop_memories_test: Sequence[str] = (),
                 activation: str = "relu"):
        super().__init__()
        if structure not in ("parallel", "sequential", "mixed", "gate"):
            raise NotImplementedError(
                f"query encoder structure {structure!r}")
        self.memories = list(memories)
        self.structure = structure
        self.memory_dropout = memory_dropout
        self.memory_generator: Optional[torch.Generator] = None
        self.drop_memories_test = set(drop_memories_test)
        self.spatial_selfattn = spatial_selfattn
        if spatial_selfattn:
            self.self_attn = SpatialSelfAttentionLayer(d_model, n_head,
                                                       dropout=dropout)
        else:
            self.self_attn = SelfAttentionLayer(d_model, n_head, dropout)
        for m in self.memories:
            self.add_module(f"cross_attns_{m}",
                            CrossAttentionLayer(d_model, n_head, dropout))
        self.ffn = FFNLayer(d_model, dim_feedforward, dropout, activation)
        if structure == "gate":
            self.gate_proj = nn.Linear(d_model, d_model)

    def _cross(self, m, query, inputs, query_pos):
        feat, mask, pos = inputs[m]
        return getattr(self, f"cross_attns_{m}")(
            query, feat, attend_mask=mask, query_pos=query_pos, pos=pos)

    def _sequential_ca(self, query, names, inputs, query_pos):
        for m in names:
            query = self._cross(m, query, inputs, query_pos)
        return query

    def _parallel_ca(self, query, names, inputs, query_pos):
        updates = [self._cross(m, query, inputs, query_pos) for m in names]
        stacked = torch.stack(updates, 1)            # (B, M, Q, D)
        if self.training and self.memory_dropout > 0.0:
            if self.memory_generator is None:
                raise RuntimeError(
                    "memory_dropout draws from its own generator: call "
                    "set_memory_generator (the trainer seeds it)")
            u = torch.rand((query.shape[0], len(names)),
                           generator=self.memory_generator,
                           device=query.device)
            return memory_keep_mean(stacked, u, self.memory_dropout)
        return stacked.mean(1)

    def forward(self, query: torch.Tensor, inputs: Dict[str, Memory],
                pairwise_locs: Optional[torch.Tensor] = None):
        _, query_valid, query_pos = inputs["query"]
        names = [m for m in self.memories
                 if self.training or m not in self.drop_memories_test]
        if self.structure == "sequential":
            query = self._sequential_ca(query, names, inputs, query_pos)
        elif self.structure == "parallel":
            query = self._parallel_ca(query, names, inputs, query_pos)
        elif self.structure == "mixed":
            # scene memories in parallel, then the prompt
            query = self._parallel_ca(
                query, [m for m in names if m != "prompt"], inputs,
                query_pos)
            query = self._sequential_ca(query, ["prompt"], inputs,
                                        query_pos)
        else:   # gate
            prompt = self._sequential_ca(query, ["prompt"], inputs,
                                         query_pos)
            gate = torch.sigmoid(self.gate_proj(prompt))
            update = self._parallel_ca(
                query, [m for m in self.memories if m != "prompt"], inputs,
                query_pos)
            query = (1.0 - gate) * query + gate * update
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
    ``query -> (cls_logits, mask_logits, attend_mask)`` (the logits None
    when the head skips its prediction); rounds are unrolled (num_blocks x
    num_layers is small and static)."""

    def __init__(self, hidden_size: int = 768, num_attention_heads: int = 12,
                 num_layers: int = 4, num_blocks: int = 1,
                 memories: Sequence[str] = ("voxel", "mv", "pc"),
                 structure: str = "parallel", spatial_selfattn: bool = True,
                 use_self_mask: bool = False, memory_dropout: float = 0.0,
                 drop_memories_test: Sequence[str] = ()):
        super().__init__()
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.memories = list(memories)
        self.use_self_mask = use_self_mask
        for i in range(num_layers):
            self.add_module(f"layer{i}", QueryEncoderLayer(
                hidden_size, num_attention_heads, self.memories,
                spatial_selfattn=spatial_selfattn, structure=structure,
                memory_dropout=memory_dropout,
                drop_memories_test=drop_memories_test))

    def set_memory_generator(self, generator: torch.Generator) -> None:
        """The generator every layer's memory dropout draws from."""
        for i in range(self.num_layers):
            getattr(self, f"layer{i}").memory_generator = generator

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
                    if cls_logits is not None:
                        predictions_class.append(cls_logits)
                        predictions_mask.append(mask_logits)
                    if self.use_self_mask and attend is not None:
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


class QueryEncoder(nn.Module):
    """The non-mask decoder (the JAX package's registered ``QueryEncoder``,
    which no config builds there either): ``num_layers`` layers over the
    memories with no mask prediction, after whole-memory sample dropout.
    In train mode each scene memory (every memory but ``prompt``) of each
    sample is zeroed, feature and position, with probability
    ``memory_dropout``: one uniform draw a sample and memory, the memories
    in order, from the generator that ``set_memory_generator`` gives,
    never the global RNG.  In eval mode the memories in
    ``drop_memories_test`` are zeroed for every sample.  The attend masks
    stay.  Layer i reads voxel level i when the ``voxel`` memory's feature
    is a list.  Returns ``(query, [], [])``."""

    def __init__(self, hidden_size: int = 768, num_attention_heads: int = 12,
                 num_layers: int = 4,
                 memories: Sequence[str] = ("mv", "pc", "prompt"),
                 structure: str = "sequential",
                 spatial_selfattn: bool = False, memory_dropout: float = 0.0,
                 drop_memories_test: Sequence[str] = ()):
        super().__init__()
        self.num_layers = num_layers
        self.memories = list(memories)
        self.memory_dropout = memory_dropout
        self.drop_memories_test = set(drop_memories_test)
        self.memory_generator: Optional[torch.Generator] = None
        for i in range(num_layers):
            self.add_module(f"layer{i}", QueryEncoderLayer(
                hidden_size, num_attention_heads, self.memories,
                spatial_selfattn=spatial_selfattn, structure=structure))

    def set_memory_generator(self, generator: torch.Generator) -> None:
        """The generator the memory dropout draws from."""
        self.memory_generator = generator

    def drop_memories(self, inputs: Dict[str, Memory]) -> Dict[str, Memory]:
        """``inputs`` with the dropped scene memories zeroed (see the
        class docstring); the same dict when none can drop."""
        if not ((self.training and self.memory_dropout > 0)
                or (not self.training and self.drop_memories_test)):
            return inputs
        if self.training and self.memory_generator is None:
            raise RuntimeError("memory_dropout draws from its own "
                               "generator: call set_memory_generator")
        inputs = dict(inputs)
        for m in self.memories:
            if m == "prompt":
                continue
            feat, mask, pos = inputs[m]
            if self.training:
                drop = torch.rand((feat.shape[0],),
                                  generator=self.memory_generator,
                                  device=feat.device) < self.memory_dropout
            else:
                drop = torch.full((feat.shape[0],),
                                  m in self.drop_memories_test,
                                  dtype=torch.bool, device=feat.device)
            feat = torch.where(drop[:, None, None], 0.0, feat)
            if pos is not None:
                pos = torch.where(drop[:, None, None], 0.0, pos)
            inputs[m] = (feat, mask, pos)
        return inputs

    def forward(self, inputs: Dict[str, Memory],
                pairwise_locs: Optional[torch.Tensor] = None):
        inputs = dict(self.drop_memories(inputs))
        query = inputs["query"][0]
        voxel_feat = inputs.get("voxel", (None,))[0]
        for i in range(self.num_layers):
            if isinstance(voxel_feat, (list, tuple)):
                _, mask, pos = inputs["voxel"]
                inputs["voxel"] = (voxel_feat[i], mask, pos)
            query = getattr(self, f"layer{i}")(query, inputs, pairwise_locs)
        return query, [], []
