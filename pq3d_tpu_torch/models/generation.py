"""T5 generation head (PyTorch); counterpart of
``pq3d_tpu/models/generation.py``: the query embeddings, projected
(``input_proj`` + LayerNorm) to the decoder's width, are the T5 decoder's
encoder states; teacher-forced logits when labels are given, greedy
decoding otherwise."""
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
        self.input_proj = nn.Linear(hidden_size, cfg.d_model)
        self.LayerNorm_0 = nn.LayerNorm(cfg.d_model, eps=FLAX_LN_EPS)
        self.decoder = T5Decoder(vocab_size=cfg.vocab_size,
                                 d_model=cfg.d_model, d_kv=cfg.d_kv,
                                 d_ff=cfg.d_ff, num_layers=cfg.num_layers,
                                 heads=cfg.num_heads)

    def forward(self, query_embeds: torch.Tensor, query_valid: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        enc = self.LayerNorm_0(self.input_proj(query_embeds))
        if labels is None:
            return self.decoder.decode(enc, query_valid,
                                       self.cfg.max_new_tokens,
                                       early_exit=self.cfg.early_exit)
        # teacher forcing: shift right with the decoder start (= PAD) token
        prev = labels[:, :-1].long()
        dec_in = F.pad(prev, (1, 0), value=T5_PAD_ID)
        dec_valid = F.pad(prev != T5_PAD_ID, (1, 0), value=True)
        return self.decoder(dec_in, enc, query_valid, dec_valid)
