"""Shared neural layers (PyTorch); counterpart of
``pq3d_tpu/models/layers.py``, the stage-1 subset.

Masks are **True = attend / valid** throughout.  Cross attention
reproduces torch's ``add_zero_attn=True`` (an extra all-zero key/value slot
with logit 0) so fully-masked rows stay finite.

Submodules carry the flax names of the JAX package (``Dense_0``,
``LayerNorm_0``, ``q_proj``, ...), so ``utils/weights.load_flax_variables``
moves a JAX checkpoint by path.  Dropout sits where the JAX layers put
it, as ``nn.Dropout`` modules, so ``model.train()`` / ``model.eval()``
switch it (the JAX ``deterministic`` flag).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

NEG_INF = -1e9
FLAX_LN_EPS = 1e-6   # flax.linen.LayerNorm's default epsilon


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, k = x.shape
    return x.transpose(1, 2).reshape(b, l, h * k)


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor],
                   zero_attn: bool = False) -> torch.Tensor:
    """Softmax over the last axis with an attend-mask (True = attend); with
    ``zero_attn`` an implicit extra slot with logit 0 joins the
    normalization and its weight is dropped."""
    logits = logits.float()
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    if zero_attn:
        zeros = logits.new_zeros(logits.shape[:-1] + (1,))
        return torch.softmax(torch.cat([logits, zeros], -1), -1)[..., :-1]
    return torch.softmax(logits, -1)


class MLPHead(nn.Module):
    """Linear -> ReLU -> LayerNorm(eps 1e-12) -> Dropout -> Linear."""

    def __init__(self, in_size: int, hidden_size: int, output_size: int,
                 dropout: float = 0.0):
        super().__init__()
        self.Dense_0 = nn.Linear(in_size, hidden_size)
        self.LayerNorm_0 = nn.LayerNorm(hidden_size, eps=1e-12)
        self.drop = nn.Dropout(dropout)
        self.Dense_1 = nn.Linear(hidden_size, output_size)

    def forward(self, x):
        return self.Dense_1(self.drop(self.LayerNorm_0(
            F.relu(self.Dense_0(x)))))


class MultiHeadAttention(nn.Module):
    """Standard MHA with optional zero-attention slot; ``attn_mask`` may be
    (B, Kv), (B, Q, Kv) or (B, H, Q, Kv), True = attend."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.0,
                 zero_attn: bool = False):
        super().__init__()
        self.n_head = n_head
        self.zero_attn = zero_attn
        self.drop = nn.Dropout(dropout)
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, attn_mask=None):
        h = self.n_head
        qp = _split_heads(self.q_proj(q), h)
        kp = _split_heads(self.k_proj(k), h)
        vp = _split_heads(self.v_proj(v), h)
        scale = 1.0 / math.sqrt(qp.shape[-1])
        logits = torch.einsum("bhqk,bhtk->bhqt", qp * scale, kp)
        if attn_mask is not None:
            if attn_mask.dim() == 2:       # key padding (B, Kv)
                attn_mask = attn_mask[:, None, None, :]
            elif attn_mask.dim() == 3:     # (B, Q, Kv)
                attn_mask = attn_mask[:, None, :, :]
        probs = self.drop(masked_softmax(logits, attn_mask,
                                         zero_attn=self.zero_attn))
        out = torch.einsum("bhqt,bhtv->bhqv", probs.to(vp.dtype), vp)
        return self.out_proj(_merge_heads(out))


class SelfAttentionLayer(nn.Module):
    """Post-norm residual self-attention with positional add."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.0):
        super().__init__()
        self.MultiHeadAttention_0 = MultiHeadAttention(d_model, n_head,
                                                       dropout)
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, tgt, attend_mask=None, query_pos=None):
        qk = tgt if query_pos is None else tgt + query_pos
        return self.LayerNorm_0(tgt + self.drop(self.MultiHeadAttention_0(
            qk, qk, tgt, attn_mask=attend_mask)))


class CrossAttentionLayer(nn.Module):
    """Post-norm residual cross-attention with the zero-attn slot."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.0):
        super().__init__()
        self.MultiHeadAttention_0 = MultiHeadAttention(d_model, n_head,
                                                       dropout,
                                                       zero_attn=True)
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, tgt, memory, attend_mask=None, query_pos=None,
                pos=None):
        q = tgt if query_pos is None else tgt + query_pos
        k = memory if pos is None else memory + pos
        return self.LayerNorm_0(tgt + self.drop(self.MultiHeadAttention_0(
            q, k, memory, attn_mask=attend_mask)))


class FFNLayer(nn.Module):
    """Post-norm residual feed-forward (ReLU); one dropout after the
    activation and one on the residual branch, as in the JAX layer."""

    def __init__(self, d_model: int, dim_feedforward: int = 2048,
                 dropout: float = 0.0):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.Dense_0 = nn.Linear(d_model, dim_feedforward)
        self.Dense_1 = nn.Linear(dim_feedforward, d_model)
        self.drop = nn.Dropout(dropout)

    def forward(self, tgt):
        h = self.drop(F.relu(self.Dense_0(tgt)))
        return self.LayerNorm_0(tgt + self.drop(self.Dense_1(h)))


class MultiHeadAttentionSpatial(nn.Module):
    """Self-attention fused with pairwise spatial geometry, 'mul' fusion:
    softmax(qk^T * scale + log(clip(relu(loc_fc(pairwise)), 1e-6)))."""

    def __init__(self, d_model: int, n_head: int, spatial_dim: int = 5,
                 dropout: float = 0.0):
        super().__init__()
        self.n_head = n_head
        self.drop = nn.Dropout(dropout)
        self.w_qs = nn.Linear(d_model, d_model)
        self.w_ks = nn.Linear(d_model, d_model)
        self.w_vs = nn.Linear(d_model, d_model)
        self.pairwise_loc_fc = nn.Linear(spatial_dim, n_head)
        self.fc = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, pairwise_locs, key_attend_mask=None):
        h = self.n_head
        qp = _split_heads(self.w_qs(q), h)
        kp = _split_heads(self.w_ks(k), h)
        vp = _split_heads(self.w_vs(v), h)
        scale = 1.0 / math.sqrt(qp.shape[-1])
        attn = torch.einsum("bhqk,bhtk->bhqt", qp, kp).float() * scale
        loc = F.relu(self.pairwise_loc_fc(pairwise_locs))
        loc = loc.permute(0, 3, 1, 2).float()            # (B, h, L, L)
        if key_attend_mask is not None:
            km = key_attend_mask[:, None, None, :]
            attn = torch.where(km, attn, NEG_INF)
            loc = torch.where(km, loc, 0.0)
        fused = torch.softmax(torch.log(loc.clamp_min(1e-6)) + attn, -1)
        fused = self.drop(fused)
        out = torch.einsum("bhqt,bhtv->bhqv", fused.to(vp.dtype), vp)
        return self.fc(_merge_heads(out)), fused


class SpatialSelfAttentionLayer(nn.Module):
    """Post-norm residual wrapper around MultiHeadAttentionSpatial."""

    def __init__(self, d_model: int, n_head: int, spatial_dim: int = 5,
                 dropout: float = 0.0):
        super().__init__()
        self.MultiHeadAttentionSpatial_0 = MultiHeadAttentionSpatial(
            d_model, n_head, spatial_dim, dropout)
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, tgt, pairwise_locs, key_attend_mask=None,
                query_pos=None):
        qk = tgt if query_pos is None else tgt + query_pos
        out, _ = self.MultiHeadAttentionSpatial_0(
            qk, qk, tgt, pairwise_locs, key_attend_mask=key_attend_mask)
        return self.LayerNorm_0(tgt + self.drop(out))


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid rows of flat (N, C) voxel features, then a
    float-multiply by the validity mask (the JAX package's form: identical
    to a select for finite values).

    Train mode normalises with the batch statistics of the valid rows and
    the BIASED variance, and updates the running statistics in place with
    the same biased variance, ``new = (1-m)*old + m*batch`` (torch's
    ``BatchNorm`` would keep the unbiased one).  Eval mode uses the running
    statistics."""

    def __init__(self, channels: int, momentum: float = 0.02,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x, valid):
        xf = x.float()
        if self.training:
            w = valid[:, None].float()
            cnt = w.sum().clamp_min(1.0)
            mean = (xf * w).sum(0) / cnt
            var = ((xf - mean).square() * w).sum(0) / cnt
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(1 - m).add_(m * mean)
                self.var.mul_(1 - m).add_(m * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.scale + self.bias
        y = y * valid[..., None].to(y.dtype)
        return y.to(x.dtype)
