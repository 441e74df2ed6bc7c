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

import contextlib
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pq3d_tpu_torch.parallel.dist import all_reduce_sum
from pq3d_tpu_torch.parallel.dist import rows as row_ranks

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
        # under tensor parallelism (parallel/tp.py) the module runs heads
        # [head_offset, head_offset + n_head) of its own
        self.head_offset = 0
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
            elif attn_mask.shape[1] > h:   # (B, H, Q, Kv): this rank's heads
                attn_mask = attn_mask[:, self.head_offset:
                                      self.head_offset + h]
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


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _glu(x: torch.Tensor) -> torch.Tensor:
    return F.glu(x, dim=-1)


ACTIVATIONS = {"relu": F.relu, "gelu": _gelu_tanh, "glu": _glu}


def get_activation(name: str):
    """The FFN's activation by its JAX name: ``relu``; ``gelu`` as
    ``jax.nn.gelu`` computes it by default, the tanh approximation;
    ``glu``, the last axis halved, ``a * sigmoid(b)``.  Another name
    raises ``KeyError``, as in the JAX package."""
    return ACTIVATIONS[name]


class FFNLayer(nn.Module):
    """Post-norm residual feed-forward; one dropout after the activation
    (``get_activation``; ``glu`` halves the hidden width that ``Dense_1``
    reads) and one on the residual branch, as in the JAX layer."""

    def __init__(self, d_model: int, dim_feedforward: int = 2048,
                 dropout: float = 0.0, activation: str = "relu"):
        super().__init__()
        self.activation = activation
        self.act = get_activation(activation)
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.Dense_0 = nn.Linear(d_model, dim_feedforward)
        self.Dense_1 = nn.Linear(dim_feedforward // 2 if activation == "glu"
                                 else dim_feedforward, d_model)
        self.drop = nn.Dropout(dropout)

    def forward(self, tgt):
        h = self.drop(self.act(self.Dense_0(tgt)))
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


def global_moments(x: torch.Tensor, w: torch.Tensor):
    """Mean and biased variance per channel of the rows of ``x`` (N, C)
    weighted by ``w`` (N, 1), over every rank of the row group
    (``parallel/dist.rows``: the ranks that hold different rows; tp peers
    share theirs and are not counted twice): the weighted sums and the
    count in one all-reduce, then the squared deviations from the global
    mean in a second (two passes, as one process computes them); both
    all-reduces carry the gradient back to every rank's rows."""
    s = all_reduce_sum(torch.cat([(x * w).sum(0), w.sum()[None]]))
    cnt = s[-1].clamp_min(1.0)
    mean = s[:-1] / cnt
    var = all_reduce_sum(((x - mean).square() * w).sum(0)) / cnt
    return mean, var


_FROZEN_STATS = [0]


@contextlib.contextmanager
def frozen_running_stats():
    """Inside the block a train-mode ``MaskedBatchNorm`` normalises with
    the batch statistics as usual but leaves its running statistics
    alone: a checkpointed block's recomputation in the backward
    (``models/sparse_unet.remat_call``) would otherwise update them a
    second time, which the JAX package's functional remat never does."""
    _FROZEN_STATS[0] += 1
    try:
        yield
    finally:
        _FROZEN_STATS[0] -= 1


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid rows of flat (N, C) voxel features, then a
    float-multiply by the validity mask (the JAX package's form: identical
    to a select for finite values).

    Train mode normalises with the batch statistics of the valid rows and
    the BIASED variance, and updates the running statistics in place with
    the same biased variance, ``new = (1-m)*old + m*batch`` (torch's
    ``BatchNorm`` would keep the unbiased one).  Eval mode uses the running
    statistics.  Under a process group of more than one rank the statistics
    are those of every rank's valid rows (``global_moments``): the JAX
    package's sync-BN semantics, where the batch is one array."""

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
            if row_ranks() > 1:
                mean, var = global_moments(xf, w)
            else:
                cnt = w.sum().clamp_min(1.0)
                mean = (xf * w).sum(0) / cnt
                var = ((xf - mean).square() * w).sum(0) / cnt
            with torch.no_grad():
                # the same ops in a recomputation, whose selective
                # checkpoint replays saved outputs in call order; only
                # the write is skipped there
                m = self.momentum
                new_mean = self.mean * (1 - m) + m * mean
                new_var = self.var * (1 - m) + m * var
                if not _FROZEN_STATS[0]:
                    self.mean.copy_(new_mean)
                    self.var.copy_(new_var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.scale + self.bias
        y = y * valid[..., None].to(y.dtype)
        return y.to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with flax's conventions: train mode
    normalises with the batch's mean and BIASED variance over every other
    axis and moves the running statistics by ``momentum`` (torch's sense:
    ``new = (1-m)*old + m*batch``, flax's momentum 0.9 is m = 0.1) with the
    same biased variance; eval mode uses the running statistics.  It keeps
    no ``num_batches_tracked``, which flax has no leaf for.  Under a
    process group of more than one rank train mode reduces over every
    rank's rows, as ``MaskedBatchNorm`` does."""

    momentum = 0.1
    eps = 1e-5

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if self.training:
            if row_ranks() > 1:
                rows = x.reshape(-1, x.shape[-1])
                mean, var = global_moments(rows, rows.new_ones(len(rows), 1))
            else:
                dims = tuple(range(x.dim() - 1))
                mean = x.mean(dims)
                var = (x - mean).square().mean(dims)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias
