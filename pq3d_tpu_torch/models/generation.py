"""T5 generation head (PyTorch); counterpart of
``pq3d_tpu/models/generation.py``: the query embeddings, projected
(``input_proj`` + LayerNorm; as they are without ``use_projection``) to
the decoder's width, are the T5 decoder's encoder states; teacher-forced
logits when labels are given, greedy decoding otherwise.  Under
``two_phase`` the head returns those states instead of decoding, and
``decode_states`` runs the same greedy decode over them as a second call
(JAX compiles the two phases separately; here both are queued on one
stream with nothing read back between them)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pq3d_tpu_torch.models.layers import FLAX_LN_EPS
from pq3d_tpu_torch.models.t5 import T5_PAD_ID, T5Decoder


class T5GenerationHead(nn.Module):
    """``cfg`` is a ``models.query3d.GenerationHeadCfg``."""

    def __init__(self, hidden_size: int, cfg):
        super().__init__()
        self.cfg = cfg
        if cfg.use_projection:
            self.input_proj = nn.Linear(hidden_size, cfg.d_model)
            self.LayerNorm_0 = nn.LayerNorm(cfg.d_model, eps=FLAX_LN_EPS)
        elif hidden_size != cfg.d_model:
            raise ValueError(
                f"use_projection: False needs the queries at the decoder's "
                f"width (hidden {hidden_size}, d_model {cfg.d_model})")
        self.decoder = T5Decoder(vocab_size=cfg.vocab_size,
                                 d_model=cfg.d_model, d_kv=cfg.d_kv,
                                 d_ff=cfg.d_ff, num_layers=cfg.num_layers,
                                 heads=cfg.num_heads)

    def encoder_states(self, query_embeds: torch.Tensor) -> torch.Tensor:
        if not self.cfg.use_projection:
            return query_embeds
        return self.LayerNorm_0(self.input_proj(query_embeds))

    def forward(self, query_embeds: torch.Tensor, query_valid: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        enc = self.encoder_states(query_embeds)
        if labels is None:
            if self.cfg.two_phase:
                return enc
            return decode_states(self, enc, query_valid)
        # teacher forcing: shift right with the decoder start (= PAD) token
        prev = labels[:, :-1].long()
        dec_in = F.pad(prev, (1, 0), value=T5_PAD_ID)
        dec_valid = F.pad(prev != T5_PAD_ID, (1, 0), value=True)
        return self.decoder(dec_in, enc, query_valid, dec_valid)


def decode_states(head: T5GenerationHead, enc: torch.Tensor,
                  enc_mask: torch.Tensor) -> torch.Tensor:
    """Greedy decode of ``head``'s decoder over encoder states ``enc``
    (B, M, d_model) with attend-mask ``enc_mask`` (B, M): (B,
    max_new_tokens) int32 tokens.  The second phase of a ``two_phase``
    head, whose forward returned ``enc``."""
    c = head.cfg
    return head.decoder.decode(enc, enc_mask, c.max_new_tokens,
                               early_exit=c.early_exit)
