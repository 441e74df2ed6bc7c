"""Swin3D-style sparse window-attention U-Net (PyTorch); counterpart of
``pq3d_tpu/models/swin3d.py``.

Windows are dense ``window^3`` cell grids built from the voxel
coordinates (``ops/window_maps`` on the host, ``ops/device_flat_maps`` on
the device): attention over a window is one batched attention over its
``window^3`` cells with an occupancy mask and a learned relative-position
bias, and the regular and shifted partitions are two packs (a sparse
partition needs no cyclic shift).  The attention is plain PyTorch
(``torch.matmul`` and softmax), as the JAX package computes it in XLA:

* the logits are taken in f32 from operands in the input's dtype (JAX's
  ``preferred_element_type=float32``), ``q`` scaled first;
* empty cells are masked with -1e9, not -inf: a padded window has no
  occupied cell, and -inf would make its softmax NaN;
* the softmax is f32, cast back to the input's dtype before ``@ v``;
* the MLP's GELU is the tanh form (flax's ``jax.nn.gelu`` default).

Topology is the Res16UNet contract, so ``models/encoders.SegVoxelEncoder``
takes either backbone: a 3^3 stem conv at level 0, four stride-2 down
convs each followed by a stage of Swin blocks (levels 1-4), a
transpose-conv decoder with a 1x1 skip added at each level and one Swin
block on the way up (a 3^3 conv at level 0), a final 1x1, and the same
``(final, [L4, L3, L2, L1, L0])`` outputs.  Submodules carry the flax
names (``stem``, ``down{l}``, ``stage{l}.block{i}.{norm1, attn, norm2,
mlp1, mlp2}``, ``attn.{qkv, proj, rel_bias}``, ``up{l}``, ``skip{l}``,
``dec{l}``, ``dec0``, ``final``, each conv's ``_bn``), so
``utils/weights.load_flax_variables`` moves a JAX tree one to one.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pq3d_tpu_torch.models.layers import FLAX_LN_EPS, MaskedBatchNorm
from pq3d_tpu_torch.models.sparse_unet import (NUM_LEVELS, ConvOptions,
                                               SparseConv,
                                               SparseConvTranspose,
                                               flatten_maps,
                                               offset_scene_indices,
                                               remat_call)
from pq3d_tpu_torch.ops import window_maps
from pq3d_tpu_torch.ops.sparse import fast_row_gather

SWIN_LEVELS = (1, 2, 3, 4)
MASKED_LOGIT = -1e9


def flatten_window_maps(maps: Dict[str, torch.Tensor],
                        levels: Sequence[int] = SWIN_LEVELS
                        ) -> Dict[str, torch.Tensor]:
    """(B, ...) window packs -> flat-layout packs: ``c2v`` entries index
    level-l rows and take the scene's offset ``scene * P_l``, ``slot``
    entries index cells and take ``scene * n_win_pad * w3``; -1 stays -1.
    Flat-pack batches ship the packs concatenated and offset
    (``collate_flat``), and they pass through."""
    keys = [(l, j) for l in levels for j in (0, 1)]
    if maps[f"win{levels[0]}s0_c2v"].dim() == 1:
        return {f"win{l}s{j}_{t}": maps[f"win{l}s{j}_{t}"]
                for l, j in keys for t in ("c2v", "slot")}
    out: Dict[str, torch.Tensor] = {}
    for l, j in keys:
        c2v = maps[f"win{l}s{j}_c2v"]
        out[f"win{l}s{j}_c2v"] = offset_scene_indices(
            c2v, maps[f"valid_{l}"].shape[1])
        out[f"win{l}s{j}_slot"] = offset_scene_indices(
            maps[f"win{l}s{j}_slot"], c2v.shape[1])
    return out


@functools.lru_cache(maxsize=None)
def _rel_index(window: int, device: str) -> torch.Tensor:
    # a normal tensor even when first made under inference_mode: a later
    # training forward indexes the bias parameter with it
    with torch.inference_mode(False):
        return torch.from_numpy(window_maps.relative_position_index(
            window)).long().to(device)


class WindowAttention(nn.Module):
    """Multi-head attention over dense window cells with an occupancy mask
    and a learned relative-position bias (one entry per cell offset and
    head, ``rel_bias`` ((2w-1)^3, heads))."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.window = window
        self.rel_bias = nn.Parameter(torch.zeros((2 * window - 1) ** 3,
                                                 num_heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, xw: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
        """``xw`` (nw, w3, dim) window cells, ``occ`` (nw, w3) bool."""
        nw, w3, _ = xw.shape
        h = self.num_heads
        hd = self.dim // h
        qkv = self.qkv(xw).reshape(nw, w3, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]             # (nw, h, w3, hd)
        attn = torch.matmul((q * hd ** -0.5).float(),
                            k.float().transpose(-1, -2))
        bias = self.rel_bias[_rel_index(self.window, str(xw.device))]
        attn = attn + bias.permute(2, 0, 1)[None]
        attn = torch.where(occ[:, None, None, :], attn, MASKED_LOGIT)
        attn = torch.softmax(attn, -1).to(xw.dtype)
        out = torch.matmul(attn, v).permute(0, 2, 1, 3).reshape(nw, w3,
                                                                self.dim)
        return self.proj(out)


class SwinBlock(nn.Module):
    """One sparse Swin block on flat (N, dim) voxel rows: gather the rows
    into window cells, LayerNorm, window attention, gather back to the
    rows, residual; then LayerNorm, MLP (tanh GELU), residual; pad rows
    zero."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.dim = dim
        self.w3 = window ** 3
        self.norm1 = nn.LayerNorm(dim, eps=FLAX_LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=FLAX_LN_EPS)
        self.mlp1 = nn.Linear(dim, 4 * dim)
        self.mlp2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor, c2v: torch.Tensor, slot: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        filled = c2v >= 0
        xw = fast_row_gather(x, c2v.clamp_min(0))
        xw = torch.where(filled[:, None], xw, 0).reshape(-1, self.w3,
                                                         self.dim)
        aw = self.attn(self.norm1(xw), filled.reshape(-1, self.w3))
        back = fast_row_gather(aw.reshape(-1, self.dim), slot.clamp_min(0))
        x = x + torch.where(((slot >= 0) & valid)[:, None], back, 0)
        y = self.mlp2(F.gelu(self.mlp1(self.norm2(x)), approximate="tanh"))
        return torch.where(valid[:, None], x + y, 0)


class SwinStage(nn.Module):
    """``depth`` Swin blocks, alternating the regular and shifted packs;
    ``remat`` checkpoints each block (the JAX package's ``nn.remat`` of
    its blocks: the attention logits are recomputed in the backward)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", SwinBlock(dim, num_heads, window))

    def forward(self, x, packs, valid, remat: bool = False):
        for i in range(self.depth):
            c2v, slot = packs[i % 2]
            block = getattr(self, f"block{i}")
            if remat:
                x = remat_call("full", functools.partial(
                    block, c2v=c2v, slot=slot, valid=valid), x)
            else:
                x = block(x, c2v, slot, valid)
        return x


class Swin3DUNet(nn.Module):
    """Sparse Swin U-Net over the hierarchy and window maps.

    ``forward(x, maps)`` takes ``x`` (B, P0, Cin) with the rectangular maps
    of ``collate`` or (N, Cin) with the flat maps of ``collate_flat`` (or
    ``ops/device_flat_maps``), which must hold ``win{l}s{j}_c2v`` /
    ``win{l}s{j}_slot`` for l in 1..4, and returns ``(final (B, P0,
    out_channels), [L4, L3, L2, L1, L0])`` flat feature maps of widths
    ``feature_channels``.  ``grad_mode`` routes its sparse convs as the
    Res16UNet's; ``remat`` checkpoints every Swin block in training."""

    def __init__(self, in_channels: int = 3, out_channels: int = 200,
                 channels: Sequence[int] = (48, 96, 192, 384),
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 stem_dim: int = 48, window: int = 4,
                 bn_momentum: float = 0.02,
                 grad_mode: str = "scatter_free", remat: bool = False):
        super().__init__()
        ch = list(channels)
        bm = bn_momentum
        self.window = window
        self.opts = ConvOptions(grad_mode)
        self.remat = remat
        self.stem = SparseConv(in_channels, stem_dim)
        self.stem_bn = MaskedBatchNorm(stem_dim, bm)
        prev = stem_dim
        skip_ch = [stem_dim]
        for i in range(4):
            l = i + 1
            self.add_module(f"down{l}", SparseConv(prev, ch[i], k=8))
            self.add_module(f"down{l}_bn", MaskedBatchNorm(ch[i], bm))
            self.add_module(f"stage{l}", SwinStage(ch[i], depths[i],
                                                   num_heads[i], window))
            prev = ch[i]
            skip_ch.append(prev)
        for i in range(4):
            lvl = 3 - i
            cdec = ch[lvl - 1] if lvl >= 1 else stem_dim
            self.add_module(f"up{lvl}", SparseConvTranspose(prev, cdec))
            self.add_module(f"up{lvl}_bn", MaskedBatchNorm(cdec, bm))
            self.add_module(f"skip{lvl}", nn.Linear(skip_ch[lvl], cdec,
                                                    bias=False))
            if lvl >= 1:
                self.add_module(f"dec{lvl}", SwinStage(
                    cdec, 1, num_heads[lvl - 1], window))
            else:
                self.dec0 = SparseConv(cdec, cdec)
                self.dec0_bn = MaskedBatchNorm(cdec, bm)
            prev = cdec
        self.final = nn.Linear(stem_dim, out_channels)
        self.feature_channels = [ch[3], ch[2], ch[1], ch[0], stem_dim]

    def forward(self, x: torch.Tensor, maps: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        fm = flatten_maps(maps)
        wm = flatten_window_maps(maps)
        v = [fm[f"valid_{l}"] for l in range(NUM_LEVELS)]
        if x.dim() == 2:               # flat pack: (N, Cin), N <= P0
            b, p0 = 1, v[0].shape[0]
            x = F.pad(x, (0, 0, 0, p0 - x.shape[0]))
        else:
            b, p0, _ = x.shape
            x = x.reshape(b * p0, -1)

        def packs(l):
            return [(wm[f"win{l}s{j}_c2v"], wm[f"win{l}s{j}_slot"])
                    for j in (0, 1)]

        opts = self.opts
        remat = self.remat and self.training
        out = F.relu(self.stem_bn(self.stem(x, fm["nbr3_0"], v[0],
                                            opts=opts), v[0]))
        skips = [out]
        for i in range(4):
            l = i + 1
            out = getattr(self, f"down{l}")(
                out, fm[f"child_{i}"], v[l], parent=fm[f"parent_{i}"],
                parent_off=fm[f"parent_off_{i}"], in_valid=v[i], opts=opts)
            out = F.relu(getattr(self, f"down{l}_bn")(out, v[l]))
            out = getattr(self, f"stage{l}")(out, packs(l), v[l], remat)
            skips.append(out)
        feature_maps = [out]  # L4
        for i in range(4):
            lvl = 3 - i
            out = getattr(self, f"up{lvl}")(
                out, fm[f"parent_{lvl}"], fm[f"parent_off_{lvl}"], v[lvl],
                fm[f"child_{lvl}"], v[lvl + 1], opts)
            out = F.relu(getattr(self, f"up{lvl}_bn")(out, v[lvl]))
            out = out + getattr(self, f"skip{lvl}")(skips[lvl])
            if lvl >= 1:
                out = getattr(self, f"dec{lvl}")(out, packs(lvl), v[lvl],
                                                 remat)
            else:
                out = F.relu(self.dec0_bn(self.dec0(
                    out, fm["nbr3_0"], v[0], opts=opts), v[0]))
            feature_maps.append(out)
        final = torch.where(v[0][:, None], self.final(out), 0)
        return final.reshape(b, p0, -1), feature_maps
