"""T5 decoder stack (PyTorch); counterpart of ``pq3d_tpu/models/t5.py``.

Only the decoder of T5 runs: the generation head feeds projected query
embeddings in as the encoder states.  Token embedding, pre-RMSNorm blocks
of [self-attention with a relative position bias, cross-attention over the
queries, ReLU FFN], a final RMSNorm, and logits tied to the embedding and
scaled by d_model^-0.5.  T5 attention has no 1/sqrt(d) scale; the relative
bias lives in block 0 and is shared down the stack.  The decoder's start
token is PAD (0); EOS is 1.

``T5Decoder.forward`` is teacher forcing.  ``T5Decoder.decode`` is greedy
decoding over a per-layer KV cache: each step embeds one token, writes its
K/V into the cache and attends over the cached keys; the cross-attention
K/V and the bias table are computed once before the loop.  A row that has
emitted EOS emits PAD from then on.  ``early_exit`` stops once every row
has emitted EOS (one device-to-host read a step), token-exact with the
fixed-length loop.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pq3d_tpu_torch.models.layers import masked_softmax

T5_PAD_ID = 0          # also the decoder start token
T5_EOS_ID = 1
NUM_BUCKETS = 32       # relative-position buckets


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


def relative_position_bucket(rel_pos: torch.Tensor,
                             num_buckets: int = NUM_BUCKETS,
                             max_distance: int = 128) -> torch.Tensor:
    """T5's causal relative position bucketing (the decoder's: negative
    distances only, no bidirectional split); the log bucket is truncated
    towards zero, as the JAX cast to int32 does."""
    rp = -torch.clamp_max(rel_pos, 0)
    max_exact = num_buckets // 2
    log_ratio = torch.log(rp.clamp_min(1).float() / max_exact)
    log_denom = torch.log(torch.tensor(max_distance / max_exact,
                                       dtype=torch.float32))
    large = max_exact + (log_ratio / log_denom
                         * (num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp_max(large, num_buckets - 1)
    return torch.where(rp < max_exact, rp.to(torch.int32), large)


class T5Attention(nn.Module):
    def __init__(self, d_model: int, d_kv: int, heads: int,
                 has_rel_bias: bool = False):
        super().__init__()
        inner = heads * d_kv
        self.heads = heads
        self.d_kv = d_kv
        self.q = nn.Linear(d_model, inner, bias=False)
        self.k = nn.Linear(d_model, inner, bias=False)
        self.v = nn.Linear(d_model, inner, bias=False)
        self.o = nn.Linear(inner, d_model, bias=False)
        self.relative_attention_bias = (
            nn.Embedding(NUM_BUCKETS, heads) if has_rel_bias else None)
        # under tensor parallelism (parallel/tp.py) the module runs a slice
        # of the heads, and reads that slice of the position bias: the
        # mesh whose tp group it runs over
        self.tp_mesh = None

    def _split(self, t):
        return t.reshape(t.shape[0], t.shape[1], self.heads,
                         self.d_kv).transpose(1, 2)

    def pos_bias_table(self, qlen: int, klen: int) -> torch.Tensor:
        """(1, h, qlen, klen) relative position bias."""
        dev = self.relative_attention_bias.weight.device
        rel = torch.arange(klen, device=dev)[None, :] \
            - torch.arange(qlen, device=dev)[:, None]
        bucket = relative_position_bucket(rel)
        table = self.relative_attention_bias(bucket.long()).permute(
            2, 0, 1)[None]
        if self.tp_mesh is not None:
            from pq3d_tpu_torch.parallel.tp import scatter
            table = scatter(table, self.tp_mesh, 1)
        return table

    def kv_proj(self, kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._split(self.k(kv)), self._split(self.v(kv))

    def attend(self, q, k, v, mask, pos_bias):
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k)   # no 1/sqrt(d)
        if pos_bias is not None:
            logits = logits + pos_bias
        probs = masked_softmax(logits, mask)
        out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
        out = out.transpose(1, 2).reshape(out.shape[0], -1,
                                          self.heads * self.d_kv)
        return self.o(out)

    def forward(self, x, kv, mask, pos_bias: Optional[torch.Tensor] = None):
        q = self._split(self.q(x))
        k, v = self.kv_proj(kv)
        if self.relative_attention_bias is not None and pos_bias is None:
            pos_bias = self.pos_bias_table(x.shape[1], kv.shape[1])
        return self.attend(q, k, v, mask, pos_bias), pos_bias


class T5DecoderBlock(nn.Module):
    def __init__(self, d_model: int, d_kv: int, heads: int, d_ff: int,
                 has_rel_bias: bool = False, dropout: float = 0.1):
        super().__init__()
        self.ln_self = RMSNorm(d_model)
        self.self_attn = T5Attention(d_model, d_kv, heads,
                                     has_rel_bias=has_rel_bias)
        self.ln_cross = RMSNorm(d_model)
        self.cross_attn = T5Attention(d_model, d_kv, heads)
        self.ln_ff = RMSNorm(d_model)
        self.wi = nn.Linear(d_model, d_ff, bias=False)
        self.wo = nn.Linear(d_ff, d_model, bias=False)
        self.drop = nn.Dropout(dropout)

    def forward(self, x, enc, self_mask, cross_mask, pos_bias):
        normed = self.ln_self(x)
        h, pos_bias = self.self_attn(normed, normed, self_mask, pos_bias)
        x = x + self.drop(h)
        h, _ = self.cross_attn(self.ln_cross(x), enc, cross_mask)
        x = x + self.drop(h)
        f = self.drop(F.relu(self.wi(self.ln_ff(x))))
        return x + self.drop(self.wo(f)), pos_bias

    def decode_step(self, x, cache, t, cross_mask, bias_row):
        """One token (x (B, 1, D)) at position ``t``: its K/V go into the
        self-attention cache, which it attends over up to ``t``."""
        normed = self.ln_self(x)
        k_new, v_new = self.self_attn.kv_proj(normed)
        cache["self_k"][:, :, t] = k_new[:, :, 0]
        cache["self_v"][:, :, t] = v_new[:, :, 0]
        q = self.self_attn._split(self.self_attn.q(normed))
        x = x + self.self_attn.attend(q, cache["self_k"][:, :, :t + 1],
                                      cache["self_v"][:, :, :t + 1], None,
                                      bias_row)
        q = self.cross_attn._split(self.cross_attn.q(self.ln_cross(x)))
        x = x + self.cross_attn.attend(q, cache["cross_k"], cache["cross_v"],
                                       cross_mask, None)
        return x + self.wo(F.relu(self.wi(self.ln_ff(x))))

    def decode_step_at(self, x, self_k, self_v, at, self_mask, cross_k,
                       cross_v, cross_mask, bias_row):
        """``decode_step`` with the step index a tensor (JAX's form): the
        token's K/V go into the full-width caches where ``at`` (1, 1, L, 1)
        is set, written functionally, and it attends over all L keys under
        ``self_mask`` (key <= t).  Returns (x, self_k, self_v)."""
        normed = self.ln_self(x)
        k_new, v_new = self.self_attn.kv_proj(normed)
        self_k = torch.where(at, k_new, self_k)
        self_v = torch.where(at, v_new, self_v)
        q = self.self_attn._split(self.self_attn.q(normed))
        x = x + self.self_attn.attend(q, self_k, self_v, self_mask, bias_row)
        q = self.cross_attn._split(self.cross_attn.q(self.ln_cross(x)))
        x = x + self.cross_attn.attend(q, cross_k, cross_v, cross_mask, None)
        return x + self.wo(F.relu(self.wi(self.ln_ff(x)))), self_k, self_v


class T5Decoder(nn.Module):
    """Decoder-only T5 over external encoder states."""

    def __init__(self, vocab_size: int = 32128, d_model: int = 512,
                 d_kv: int = 64, d_ff: int = 2048, num_layers: int = 6,
                 heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.heads = heads
        self.d_kv = d_kv
        self.num_layers = num_layers
        self.embed = nn.Embedding(vocab_size, d_model)
        for i in range(num_layers):
            self.add_module(f"block{i}", T5DecoderBlock(
                d_model, d_kv, heads, d_ff, has_rel_bias=(i == 0),
                dropout=dropout))
        self.ln_final = RMSNorm(d_model)
        self.drop_final = nn.Dropout(dropout)

    def _blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.num_layers)]

    def _logits(self, x):
        # tied embeddings, scaled
        return (x * self.d_model ** -0.5) @ self.embed.weight.T

    def forward(self, tokens: torch.Tensor, enc: torch.Tensor,
                enc_mask: torch.Tensor,
                dec_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced logits (B, L, vocab)."""
        x = self.embed(tokens)
        L = tokens.shape[1]
        self_mask = torch.ones(L, L, dtype=torch.bool,
                               device=tokens.device).tril()[None, None]
        if dec_valid is not None:
            self_mask = self_mask & dec_valid[:, None, None, :]
        cross_mask = enc_mask[:, None, None, :]
        pos_bias = None
        for block in self._blocks():
            x, pos_bias = block(x, enc, self_mask, cross_mask, pos_bias)
        return self._logits(self.drop_final(self.ln_final(x)))

    def decode(self, enc: torch.Tensor, enc_mask: torch.Tensor,
               max_tokens: int, early_exit: bool = False) -> torch.Tensor:
        """Greedy decode: (B, M, D) encoder states -> (B, max_tokens) token
        ids (EOS-frozen, start token stripped).

        ``early_exit=True`` runs :meth:`decode_until_eos`, one
        ``torch.while_loop`` that stops once every row has emitted EOS and
        that ``torch.export`` keeps as a loop; finished rows emit PAD
        either way, so its tokens equal the fixed-length decode's."""
        if early_exit:
            return self.decode_until_eos(enc, enc_mask, max_tokens)
        b = enc.shape[0]
        dev = enc.device
        blocks = self._blocks()
        caches = []
        for blk in blocks:
            ck, cv = blk.cross_attn.kv_proj(enc)
            caches.append({
                "self_k": ck.new_zeros(b, blk.self_attn.heads, max_tokens,
                                       self.d_kv),
                "self_v": ck.new_zeros(b, blk.self_attn.heads, max_tokens,
                                       self.d_kv),
                "cross_k": ck, "cross_v": cv})
        bias_full = blocks[0].self_attn.pos_bias_table(max_tokens,
                                                       max_tokens)
        cross_mask = enc_mask[:, None, None, :]
        cur = torch.full((b,), T5_PAD_ID, dtype=torch.long, device=dev)
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        out = torch.full((b, max_tokens), T5_PAD_ID, dtype=torch.long,
                         device=dev)
        for t in range(max_tokens):
            x = self.embed(cur[:, None])
            bias_row = bias_full[:, :, t:t + 1, :t + 1]
            for blk, cache in zip(blocks, caches):
                x = blk.decode_step(x, cache, t, cross_mask, bias_row)
            logits = self._logits(self.ln_final(x))[:, 0]
            nxt = torch.argmax(logits, dim=-1)
            nxt = torch.where(finished, T5_PAD_ID, nxt)
            finished = finished | (nxt == T5_EOS_ID)
            out[:, t] = nxt
            cur = nxt
        return out.to(torch.int32)

    def decode_until_eos(self, enc: torch.Tensor, enc_mask: torch.Tensor,
                         max_tokens: int) -> torch.Tensor:
        """The early-exit greedy decode in JAX's form
        (``pq3d_tpu/models/t5.py``, ``decode`` with ``early_exit``): a
        ``torch.while_loop`` over the state (t, cur, finished, caches, out),
        ``out`` filled with PAD, that runs while t < max_tokens and some row
        has not emitted EOS.  The loop carries the full-width self-attention
        caches, writes position t with ``torch.where`` on ``arange == t``,
        attends over every key under ``key <= t`` and picks the bias row by
        index, so no shape depends on t and nothing is read back to the
        host inside the loop."""
        b = enc.shape[0]
        dev = enc.device
        blocks = self._blocks()
        cross, caches = [], []
        for blk in blocks:
            ck, cv = blk.cross_attn.kv_proj(enc)
            cross.append((ck, cv))
            zeros = ck.new_zeros(b, blk.self_attn.heads, max_tokens,
                                 self.d_kv)
            caches.append((zeros, zeros.clone()))
        bias_full = blocks[0].self_attn.pos_bias_table(max_tokens,
                                                       max_tokens)
        cross_mask = enc_mask[:, None, None, :]
        key_iota = torch.arange(max_tokens, device=dev)

        def cond(t, cur, finished, caches, out):
            return (t < max_tokens) & ~finished.all()

        def body(t, cur, finished, caches, out):
            x = self.embed(cur[:, None])
            self_mask = (key_iota <= t)[None, None, None, :]
            at = (key_iota == t)[None, None, :, None]
            bias_row = bias_full.index_select(2, t.reshape(1))
            new_caches = []
            for blk, (sk, sv), (ck, cv) in zip(blocks, caches, cross):
                x, sk, sv = blk.decode_step_at(x, sk, sv, at, self_mask, ck,
                                               cv, cross_mask, bias_row)
                new_caches.append((sk, sv))
            # _logits as F.linear: the loop's capture would lift
            # ``embed.weight.T`` as an input that aliases the weight
            logits = F.linear(self.ln_final(x) * self.d_model ** -0.5,
                              self.embed.weight)[:, 0]
            nxt = torch.argmax(logits, dim=-1)
            nxt = torch.where(finished, T5_PAD_ID, nxt)
            finished = finished | (nxt == T5_EOS_ID)
            out = torch.where(key_iota[None, :] == t, nxt[:, None], out)
            return t + 1, nxt, finished, tuple(new_caches), out

        state = (torch.zeros((), dtype=torch.long, device=dev),
                 torch.full((b,), T5_PAD_ID, dtype=torch.long, device=dev),
                 torch.zeros(b, dtype=torch.bool, device=dev), tuple(caches),
                 torch.full((b, max_tokens), T5_PAD_ID, dtype=torch.long,
                            device=dev))
        return torch.while_loop(cond, body, state)[-1].to(torch.int32)
