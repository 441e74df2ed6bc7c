"""Megatron tensor parallelism over the mesh's ``tp`` group; the compute
side of the ``tp`` axis of ``pq3d_tpu/parallel/mesh.py``, where XLA
partitions each product by the parameters' ``PartitionSpec``.

``install`` switches every ``nn.Linear`` whose weight ``tp_spec`` shards
(``parallel/mesh.placements``) to one of four modes:

- ``col``: a column-parallel product whose output feeds something that
  needs the whole feature (``MLPHead``'s ``LayerNorm_0``, the encoders'
  ``Dense_0``, ``q_proj`` of ``heads.py``, ``MultiHeadAttentionSpatial``'s
  ``w_qs/w_ks/w_vs``, a head count ``tp`` does not divide): Megatron's
  ``f`` on the input, the rank's slice of the output features, then an
  all-gather of them;
- ``row``: a row-parallel product with no column partner: the rank's
  slice of the input features, its partial product, an all-reduce, and
  the bias once, after it;
- ``col_local`` / ``row_local``: the pairs where a column output reaches
  its row partner through elementwise ops and head-local attention only
  (``MultiHeadAttention``, ``CLIPAttention`` and ``T5Attention`` with
  ``heads % tp == 0``, ``FFNLayer`` but with ``glu``, T5's ``wi/wo``):
  the column products keep their slice (the module runs ``heads / tp``
  heads), and the row product all-reduces once, so a pair costs one
  all-reduce in the forward.

Megatron's ``f`` is the identity forward and an all-reduce of the
gradient backward (``_Copy``), ``g`` the mirror (``_Reduce``).  The
gather's backward keeps the rank's slice of the gradient, since the ops
after it run replicated on every tp peer; the scatter's backward gathers.
Every parameter no rule shards therefore ends its backward with the whole
gradient on every tp peer; T5's relative-position table, whose heads a
local attention reads a slice of, reaches it through a scatter too.  A
parameter ``tp_spec`` shards that is not a Linear's raises.

The collectives are the mesh's (``Mesh.all_reduce`` / ``all_gather``).
"""
from __future__ import annotations

import types
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

def _gather(m, t: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cat(m.all_gather(t, m.tp_group, m.cfg.tp).unbind(0),
                     dim=dim)


def _slice(m, t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.chunk(m.cfg.tp, dim=dim)[m.tp_rank].contiguous()


class _Copy(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, m):
        ctx.m = m
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.m.all_reduce(g, ctx.m.tp_group), None


class _Reduce(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, m):
        return m.all_reduce(x, m.tp_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; the rank's slice backward."""

    @staticmethod
    def forward(ctx, x, m, dim):
        ctx.m, ctx.dim = m, dim
        return _gather(m, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(ctx.m, g, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    """The rank's slice along ``dim`` forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, m, dim):
        ctx.m, ctx.dim = m, dim
        return _slice(m, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(ctx.m, g, ctx.dim), None, None


def scatter(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The rank's slice of ``x`` along ``dim`` over ``mesh``'s tp group
    (the gradient gathered)."""
    return _Scatter.apply(x, mesh, dim)


def linear(lin: nn.Linear, x: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``lin(x)`` in ``lin.tp_mode`` over ``lin.tp_mesh``'s tp group; with
    ``dtype``, the input and the parameters cast to it first (CLIP's bf16
    tower)."""
    mode, m = lin.tp_mode, lin.tp_mesh
    w, b = lin.weight, lin.bias
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
        b = None if b is None else b.to(dtype)
    if mode in ("col", "col_local"):
        y = F.linear(_Copy.apply(x, m), w)
        if b is not None and b.shape[0] == w.shape[0]:   # sharded bias
            y = y + b
            b = None
        elif b is not None and mode == "col_local":
            # a replicated bias (no tp rule took it): its slice, so that
            # its gradient comes back whole on every tp peer
            y = y + _Scatter.apply(b, m, 0)
            b = None
        if mode == "col":
            y = _Gather.apply(y, m, -1)
        return y if b is None else y + b
    if mode == "row":
        x = _Scatter.apply(x, m, -1)
    y = _Reduce.apply(F.linear(x, w), m)
    return y if b is None else y + b


def _forward(self: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return linear(self, x)


def _set(lin: nn.Linear, mode: str, mesh) -> None:
    lin.tp_mode = mode
    lin.tp_mesh = mesh
    lin.forward = types.MethodType(_forward, lin)


def install(model: nn.Module, mesh, placements: Dict[str, tuple]) -> None:
    """Switch ``model``'s tp-sharded Linears to their modes (module
    docstring) and the attention modules of a pair to their local heads.
    The parameters are already the rank's blocks."""
    from pq3d_tpu_torch.models.clip_text import CLIPAttention
    from pq3d_tpu_torch.models.layers import FFNLayer, MultiHeadAttention
    from pq3d_tpu_torch.models.t5 import T5Attention, T5DecoderBlock
    tp = mesh.cfg.tp
    params = dict(model.named_parameters())
    places = {id(params[n]): pl for n, pl in placements.items()}
    kind: Dict[int, str] = {}
    owned = set()
    for mod in model.modules():
        if not isinstance(mod, nn.Linear):
            continue
        pl = places[id(mod.weight)]
        owned.add(id(mod.weight))
        if mod.bias is not None:
            owned.add(id(mod.bias))
        if pl[0] == "tp":
            kind[id(mod)] = "col"
        elif pl[1] == "tp":
            kind[id(mod)] = "row"
    stray = [n for n, pl in placements.items()
             if "tp" in pl and id(params[n]) not in owned]
    if stray:
        raise NotImplementedError(
            f"tensor parallelism shards parameters that are no Linear's: "
            f"{stray}")

    def pair(cols, row, heads: Optional[int]) -> bool:
        ok = (all(kind.get(id(c)) == "col" for c in cols)
              and kind.get(id(row)) == "row"
              and (heads is None or heads % tp == 0))
        if ok:
            for c in cols:
                _set(c, "col_local", mesh)
            _set(row, "row_local", mesh)
        return ok

    for mod in model.modules():
        if isinstance(mod, MultiHeadAttention):
            if pair((mod.q_proj, mod.k_proj, mod.v_proj), mod.out_proj,
                    mod.n_head):
                mod.n_head //= tp
                mod.head_offset = mesh.tp_rank * mod.n_head
        elif isinstance(mod, CLIPAttention):
            if pair((mod.q_proj, mod.k_proj, mod.v_proj), mod.out_proj,
                    mod.heads):
                mod.heads //= tp
        elif isinstance(mod, T5Attention):
            if pair((mod.q, mod.k, mod.v), mod.o, mod.heads):
                mod.heads //= tp
                mod.tp_mesh = mesh
        elif isinstance(mod, FFNLayer) and mod.activation != "glu":
            # glu multiplies feature j by feature j + F/2, which another
            # tp peer's column slice holds: col and row for it
            pair((mod.Dense_0,), mod.Dense_1, None)
        elif isinstance(mod, T5DecoderBlock):
            pair((mod.wi,), mod.wo, None)
    for mod in model.modules():
        if id(mod) in kind and not hasattr(mod, "tp_mode"):
            _set(mod, kind[id(mod)], mesh)
