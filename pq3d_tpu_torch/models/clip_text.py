"""CLIP text tower and the prompt's text encoders (PyTorch); counterpart of
``pq3d_tpu/models/clip_text.py`` (``quick_gelu``, ``CLIPAttention``,
``CLIPBlock``, ``CLIPTextTower``, ``CLIPTextEncoder``,
``BERTTextEncoder``).

The tower is a causal pre-LN transformer (LayerNorm eps 1e-5, quick-gelu
MLP) whose every token is projected by ``text_projection``; the encoder
runs it (frozen by default: without autograd), L2-normalises each token's
features (nothing is pooled) and applies the trainable projection, an MLP
or ``num_projection_layers`` self-attention layers of 12 heads.
Attention is causal AND the prompt's attend-mask.  With ``compute_dtype``
``bfloat16`` the tower's dense layers cast their input and parameters to
bf16 and return bf16 (flax ``Dense(dtype=bf16)``); the residual stream,
the layer norms and the softmax stay f32, and the encoder returns f32.
Submodules and raw parameters carry the flax names.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pq3d_tpu_torch.models.layers import (MLPHead, SelfAttentionLayer,
                                          masked_softmax)

CLIP_LN_EPS = 1e-5
BERT_LN_EPS = 1e-12


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(1.702 x)`` as XLA evaluates it: the constant rounded
    to x's dtype, the sigmoid as ``1 / (1 + exp(-z))``, each op rounded."""
    c = float(torch.tensor(1.702, dtype=x.dtype))
    return x * (1 / (1 + torch.exp(-(c * x))))


def _dense(lin: nn.Linear, x: torch.Tensor,
           dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``lin(x)``, or with ``dtype`` its input and parameters cast to it
    (under tensor parallelism, in the Linear's mode: ``parallel/tp``)."""
    if dtype is None:
        return lin(x)
    if hasattr(lin, "tp_mode"):
        from pq3d_tpu_torch.parallel.tp import linear
        return linear(lin, x, dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, attend_mask):
        b, L, _ = x.shape
        h = self.heads
        d = self.q_proj.weight.shape[0] // h    # the heads this rank runs

        def split(t):
            return t.reshape(b, L, h, d).transpose(1, 2)
        q = split(_dense(self.q_proj, x, self.dtype))
        k = split(_dense(self.k_proj, x, self.dtype))
        v = split(_dense(self.v_proj, x, self.dtype))
        # sqrt(d) rounded to q's dtype first, as JAX's weakly typed scalar
        root = float(torch.tensor(math.sqrt(d), dtype=q.dtype))
        logits = torch.einsum("bhqd,bhkd->bhqk", q / root, k)
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        mask = causal[None, None] & attend_mask[:, None, None, :]
        probs = masked_softmax(logits, mask)
        out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
        return _dense(self.out_proj, out.transpose(1, 2).reshape(b, L, -1),
                      self.dtype)


class CLIPBlock(nn.Module):
    def __init__(self, width: int, heads: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(width, eps=CLIP_LN_EPS)
        self.attn = CLIPAttention(width, heads, dtype)
        self.ln_2 = nn.LayerNorm(width, eps=CLIP_LN_EPS)
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)

    def forward(self, x, attend_mask):
        x = x + self.attn(self.ln_1(x), attend_mask)
        h = quick_gelu(_dense(self.fc1, self.ln_2(x), self.dtype))
        return x + _dense(self.fc2, h, self.dtype)


class CLIPTextTower(nn.Module):
    """Token + position embedding, causal blocks, final LN, projection
    (width -> width)."""

    def __init__(self, vocab_size: int = 49408, width: int = 768,
                 heads: int = 12, layers: int = 12, max_positions: int = 77,
                 compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {compute_dtype!r}")
        dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.layers = layers
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(max_positions, width))
        for i in range(layers):
            self.add_module(f"block{i}", CLIPBlock(width, heads, dtype))
        self.ln_final = nn.LayerNorm(width, eps=CLIP_LN_EPS)
        self.text_projection = nn.Parameter(torch.zeros(width, width))

    def forward(self, ids: torch.Tensor, attend_mask: torch.Tensor):
        x = self.token_embedding(ids) \
            + self.positional_embedding[:ids.shape[1]]
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x, attend_mask)
        return self.ln_final(x) @ self.text_projection


class CLIPTextEncoder(nn.Module):
    """Tower (without autograd when ``freeze_backbone``) -> f32 -> per-token
    L2 norm -> the trainable projection (``mlp``: ``projection``;
    ``attention``: ``projection{i}``) unless ``use_projection`` is off."""

    def __init__(self, output_dim: int = 768, dropout: float = 0.1,
                 vocab_size: int = 49408, width: int = 768,
                 tower_heads: int = 12, tower_layers: int = 12,
                 freeze_backbone: bool = True, use_projection: bool = True,
                 projection_type: str = "mlp",
                 num_projection_layers: int = 1,
                 compute_dtype: str = "float32"):
        super().__init__()
        if projection_type not in ("mlp", "attention"):
            raise NotImplementedError(projection_type)
        self.freeze_backbone = freeze_backbone
        self.use_projection = use_projection
        self.projection_type = projection_type
        self.num_projection_layers = num_projection_layers
        self.tower = CLIPTextTower(vocab_size=vocab_size, width=width,
                                   heads=tower_heads, layers=tower_layers,
                                   compute_dtype=compute_dtype)
        if use_projection and projection_type == "mlp":
            self.projection = MLPHead(width, output_dim, output_dim, dropout)
        elif use_projection:
            for i in range(num_projection_layers):
                self.add_module(f"projection{i}",
                                SelfAttentionLayer(width, 12, dropout))

    def forward(self, ids: torch.Tensor, attend_mask: torch.Tensor):
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_backbone):
            txt = self.tower(ids, attend_mask).float()
        txt = txt / txt.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        if not self.use_projection:
            return txt
        if self.projection_type == "mlp":
            return self.projection(txt)
        for i in range(self.num_projection_layers):
            txt = getattr(self, f"projection{i}")(txt,
                                                  attend_mask=attend_mask)
        return txt


class BERTTextEncoder(nn.Module):
    """Truncated BERT-style encoder: word embedding + raw
    ``position_embeddings``, LayerNorm (eps 1e-12), then per layer a
    post-LN self-attention layer and a GELU (tanh form) FFN with its
    LayerNorm ``ffn{i}_ln`` (eps 1e-12)."""

    def __init__(self, hidden_size: int = 768, num_layers: int = 4,
                 num_heads: int = 12, vocab_size: int = 30522,
                 max_positions: int = 512):
        super().__init__()
        self.num_layers = num_layers
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Parameter(
            torch.zeros(max_positions, hidden_size))
        self.LayerNorm_0 = nn.LayerNorm(hidden_size, eps=BERT_LN_EPS)
        for i in range(num_layers):
            self.add_module(f"layer{i}",
                            SelfAttentionLayer(hidden_size, num_heads))
            self.add_module(f"ffn{i}_1",
                            nn.Linear(hidden_size, 4 * hidden_size))
            self.add_module(f"ffn{i}_2",
                            nn.Linear(4 * hidden_size, hidden_size))
            self.add_module(f"ffn{i}_ln",
                            nn.LayerNorm(hidden_size, eps=BERT_LN_EPS))

    def forward(self, ids: torch.Tensor, attend_mask: torch.Tensor):
        x = self.LayerNorm_0(self.word_embeddings(ids)
                             + self.position_embeddings[:ids.shape[1]])
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, attend_mask=attend_mask)
            h = F.gelu(getattr(self, f"ffn{i}_1")(x), approximate="tanh")
            x = getattr(self, f"ffn{i}_ln")(x + getattr(self, f"ffn{i}_2")(h))
        return x
