"""CLIP text tower and the prompt's text encoder (PyTorch); counterpart of
``pq3d_tpu/models/clip_text.py`` (``quick_gelu``, ``CLIPAttention``,
``CLIPBlock``, ``CLIPTextTower``, ``CLIPTextEncoder`` with the ``mlp``
projection).

The tower is a causal pre-LN transformer (LayerNorm eps 1e-5, quick-gelu
MLP) whose every token is projected by ``text_projection``; the encoder
runs it frozen, L2-normalises each token's features (nothing is pooled)
and applies the trainable MLP projection.  Attention is causal AND the
prompt's attend-mask.  Submodules and raw parameters carry the flax names.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from pq3d_tpu_torch.models.layers import MLPHead, masked_softmax

CLIP_LN_EPS = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, attend_mask):
        b, L, w = x.shape
        h = self.heads
        d = w // h

        def split(t):
            return t.reshape(b, L, h, d).transpose(1, 2)
        q = split(self.q_proj(x))
        k = split(self.k_proj(x))
        v = split(self.v_proj(x))
        logits = torch.einsum("bhqd,bhkd->bhqk", q / math.sqrt(d), k)
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        mask = causal[None, None] & attend_mask[:, None, None, :]
        probs = masked_softmax(logits, mask)
        out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, L, w))


class CLIPBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=CLIP_LN_EPS)
        self.attn = CLIPAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=CLIP_LN_EPS)
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)

    def forward(self, x, attend_mask):
        x = x + self.attn(self.ln_1(x), attend_mask)
        return x + self.fc2(quick_gelu(self.fc1(self.ln_2(x))))


class CLIPTextTower(nn.Module):
    """Token + position embedding, causal blocks, final LN, projection
    (width -> width)."""

    def __init__(self, vocab_size: int = 49408, width: int = 768,
                 heads: int = 12, layers: int = 12, max_positions: int = 77):
        super().__init__()
        self.layers = layers
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(max_positions, width))
        for i in range(layers):
            self.add_module(f"block{i}", CLIPBlock(width, heads))
        self.ln_final = nn.LayerNorm(width, eps=CLIP_LN_EPS)
        self.text_projection = nn.Parameter(torch.zeros(width, width))

    def forward(self, ids: torch.Tensor, attend_mask: torch.Tensor):
        x = self.token_embedding(ids) \
            + self.positional_embedding[:ids.shape[1]]
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x, attend_mask)
        return self.ln_final(x) @ self.text_projection


class CLIPTextEncoder(nn.Module):
    """Frozen tower (run without autograd) -> per-token L2 norm ->
    trainable MLP projection."""

    def __init__(self, output_dim: int = 768, dropout: float = 0.1,
                 vocab_size: int = 49408, width: int = 768,
                 tower_heads: int = 12, tower_layers: int = 12):
        super().__init__()
        self.tower = CLIPTextTower(vocab_size=vocab_size, width=width,
                                   heads=tower_heads, layers=tower_layers)
        self.projection = MLPHead(width, output_dim, output_dim, dropout)

    def forward(self, ids: torch.Tensor, attend_mask: torch.Tensor):
        with torch.no_grad():
            txt = self.tower(ids, attend_mask).float()
        txt = txt / txt.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        return self.projection(txt)
