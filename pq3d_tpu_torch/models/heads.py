"""Task heads (PyTorch); counterpart of ``MaskHeadSegLevel``,
``GroundHead``, ``GroundHeadV1`` and ``ClsHead`` in
``pq3d_tpu/models/heads.py`` (the T5 generation head is in
``generation.py``).  Mask logits are (B, S, Q) (segments x queries);
attend masks are (B, Q, S) with True = attend."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from pq3d_tpu_torch.models.layers import MLPHead, NEG_INF


class MaskPredictionLayer(nn.Module):
    """q/k projection + segment-query inner product."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.q_proj = nn.Linear(hidden_size, hidden_size)
        self.k_proj = nn.Linear(hidden_size, hidden_size, bias=False)

    def forward(self, query, key):
        return torch.einsum("bsd,bqd->bsq", self.k_proj(key),
                            self.q_proj(query))


class MaskHeadSegLevel(nn.Module):
    """Class + segment-mask prediction from queries.  Returns
    ``(cls_logits (B,Q,T), mask_logits (B,S,Q), attend_mask (B,Q,S))``
    where attend is True where sigmoid(mask logit) >= 0.5, or is
    ``offline_attn_masks`` when one is given; ``skip_prediction`` returns
    ``(None, None, offline_attn_masks)`` without predicting."""

    def __init__(self, hidden_size: int, num_targets: int,
                 num_memories: int = 1,
                 filter_out_classes: Sequence[int] = (),
                 dropout: float = 0.1):
        super().__init__()
        self.num_memories = num_memories
        self.filter_out_classes = list(filter_out_classes)
        self.cls_head = MLPHead(hidden_size, hidden_size, num_targets,
                                dropout)
        for i in range(num_memories):
            self.add_module(f"mask_pred_{i}",
                            MaskPredictionLayer(hidden_size))

    def forward(self, query: torch.Tensor,
                seg_fts_for_match: List[Tuple[torch.Tensor, torch.Tensor]],
                seg_valid: torch.Tensor,
                offline_attn_masks: Optional[torch.Tensor] = None,
                skip_prediction: bool = False):
        if skip_prediction:
            return None, None, offline_attn_masks
        cls_logits = self.cls_head(query)
        if self.filter_out_classes:
            cls_logits = cls_logits.clone()
            cls_logits[..., self.filter_out_classes] = NEG_INF
        mask_sum = 0.0
        cnt = 0.0
        for i in range(self.num_memories):
            feat, valid = seg_fts_for_match[i]
            logits = getattr(self, f"mask_pred_{i}")(query, feat)
            w = valid[..., None].to(logits.dtype)    # (B, S, 1)
            mask_sum = mask_sum + logits * w
            cnt = cnt + w
        mask_logits = mask_sum / (cnt + 1e-8)
        mask_logits = torch.where(seg_valid[..., None], mask_logits, -1e6)
        if offline_attn_masks is not None:
            attend = offline_attn_masks
        else:
            attend = _sigmoid(mask_logits).transpose(1, 2) >= 0.5
        return cls_logits, mask_logits, attend


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid``, except below f32 (the bf16 serving cast), where
    it is ``1 / (1 + exp(-x))`` rounded op by op, as XLA expands the JAX
    package's ``jax.nn.sigmoid`` there: the self-mask's attend bits (>=
    0.5) then fall where JAX's do."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


class GroundHead(nn.Module):
    """Per-query grounding logit; invalid queries get NEG_INF."""

    def __init__(self, in_size: int, hidden_size: int = 384,
                 dropout: float = 0.3):
        super().__init__()
        self.og3d_head = MLPHead(in_size, hidden_size, 1, dropout)

    def forward(self, obj_embeds: torch.Tensor,
                obj_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        logits = self.og3d_head(obj_embeds)[..., 0]
        if obj_valid is not None:
            logits = torch.where(obj_valid, logits, NEG_INF)
        return logits


class GroundHeadV1(nn.Module):
    """Legacy grounding head with auxiliary text / object classifiers:
    returns ``(txt_cls (B, C), obj_cls (B, O, C), obj_cls_pre (B, O, C),
    og3d (B, O))``, C = ``sem_cls_size``; the text classifier reads the
    first token.  ``detach_all_aux_loss`` cuts the classifiers' gradient
    into the embeddings (the grounding logit keeps its own)."""

    def __init__(self, input_size: int = 768, hidden_size: int = 768,
                 sem_cls_size: int = 607, dropout: float = 0.3,
                 detach_all_aux_loss: bool = False):
        super().__init__()
        self.detach_all_aux_loss = detach_all_aux_loss
        self.og3d_head = MLPHead(input_size, hidden_size, 1, dropout)
        self.txt_clf_head = MLPHead(input_size, hidden_size, sem_cls_size,
                                    dropout)
        self.obj3d_clf_head = MLPHead(input_size, hidden_size,
                                      sem_cls_size, dropout)
        self.obj3d_clf_pre_head = MLPHead(input_size, hidden_size,
                                          sem_cls_size, dropout)

    def forward(self, txt_embeds, obj_embeds, obj_pre_embeds, obj_valid):
        og3d = torch.where(obj_valid, self.og3d_head(obj_embeds)[..., 0],
                           NEG_INF)
        if self.detach_all_aux_loss:
            txt_embeds = txt_embeds.detach()
            obj_embeds = obj_embeds.detach()
            obj_pre_embeds = obj_pre_embeds.detach()
        return (self.txt_clf_head(txt_embeds[:, 0]),
                self.obj3d_clf_head(obj_embeds),
                self.obj3d_clf_pre_head(obj_pre_embeds), og3d)


class ClsHead(nn.Module):
    """Plain MLP classifier (the ``qa`` head's answer scores)."""

    def __init__(self, hidden_size: int, num_classes: int,
                 dropout: float = 0.3):
        super().__init__()
        self.MLPHead_0 = MLPHead(hidden_size, hidden_size, num_classes,
                                 dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.MLPHead_0(x)
