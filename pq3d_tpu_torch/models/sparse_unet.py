"""Sparse residual U-Net over host-built kernel maps (PyTorch).

Counterpart of ``pq3d_tpu/models/sparse_unet.py`` for the rectangular
layout: the Res16UNet34C topology -- dense-block 5^3 stem -> 4x stride-2
encoder ladder -> 4x transpose-conv decoder with skip concats -> final 1x1
conv -- where every sparse conv is a gather -> GEMM over precomputed
neighbor maps.  The batch of scenes is flattened into one (B*P_l, C) array
per level (``flatten_maps``).

With ``pallas_conv`` the stride-1 3^3 convs whose shape passes
``ops/zrun_conv.applicable`` run the hand-written CUDA kernel over a z-run
plan built on the device from the shipped (N, 27) maps, as the JAX package
routes them to its Pallas kernel.  The JAX package guards its windowed
kernel with an exception-overflow fallback; the Hopper kernel has no
window, so every routed conv runs the kernel.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pq3d_tpu_torch.models.layers import MaskedBatchNorm
from pq3d_tpu_torch.ops import sparse, zrun_conv

NUM_LEVELS = 5


def offset_scene_indices(idx: torch.Tensor, target_p: int) -> torch.Tensor:
    """(B, P, ...) indices into per-scene arrays of size ``target_p`` ->
    flat indices over B*target_p rows; -1 (padding) stays -1."""
    b = idx.shape[0]
    shift = (torch.arange(b, dtype=idx.dtype, device=idx.device)
             * target_p).reshape((b,) + (1,) * (idx.dim() - 1))
    return torch.where(idx >= 0, idx + shift, -1).reshape(
        (-1,) + tuple(idx.shape[2:]))


def flatten_maps(maps: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """(B, P_l, ...) index maps -> flat maps over B*P_l rows; the ancestor
    table becomes absolute flat indices per level."""
    out: Dict[str, torch.Tensor] = {}
    off = offset_scene_indices
    for l in range(NUM_LEVELS):
        p_l = maps[f"valid_{l}"].shape[1]
        out[f"valid_{l}"] = maps[f"valid_{l}"].reshape(-1)
        out[f"nbr3_{l}"] = off(maps[f"nbr3_{l}"], p_l)
    for l in range(NUM_LEVELS - 1):
        p_l = maps[f"valid_{l}"].shape[1]
        p_next = maps[f"valid_{l + 1}"].shape[1]
        out[f"child_{l}"] = off(maps[f"child_{l}"], p_l)
        out[f"parent_{l}"] = off(maps[f"parent_{l}"], p_next)
        out[f"parent_off_{l}"] = maps[f"parent_off_{l}"].reshape(-1)
    for l in range(NUM_LEVELS):
        p_l = maps[f"valid_{l}"].shape[1]
        out[f"ancestor_{l}"] = off(maps["ancestor"][:, l, :], p_l)
    b = maps["valid_0"].shape[0]
    nb = maps["stem_nbrblk"].shape[1]
    cells = maps["stem_c2v"].shape[1]
    out["stem_dense"] = maps["stem_dense"].reshape(b * nb, -1)
    out["stem_nbrblk"] = off(maps["stem_nbrblk"], nb)
    out["stem_slot"] = off(maps["stem_slot"], cells)
    out["stem_block"] = round((cells // nb) ** (1 / 3))
    return out


def _conv_weight(k: int, cin: int, cout: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(k, cin, cout))


class SparseConv(nn.Module):
    """Kernel-map sparse conv; ``kernel`` is (K, Cin, Cout) in
    kernel_offsets order (K = 27 stride-1 3^3, K = 8 stride-2 down)."""

    def __init__(self, in_channels: int, out_channels: int, k: int = 27):
        super().__init__()
        self.out_channels = out_channels
        self.kernel = _conv_weight(k, in_channels, out_channels)

    def routes(self, n_rows: int, zplan) -> bool:
        """Would this conv run the z-run kernel on ``n_rows`` rows?"""
        return (zplan is not None and self.kernel.shape[0] == 27
                and zrun_conv.applicable(n_rows, self.kernel.shape[1],
                                         self.out_channels))

    def forward(self, x, nbr, valid, zplan=None, parent=None,
                parent_off=None, in_valid=None):
        """``parent``/``parent_off``/``in_valid`` (the dual maps) make it a
        stride-2 down conv over the child map ``nbr``."""
        if parent is not None:
            return sparse.sparse_conv_down(x, nbr, self.kernel, parent,
                                           parent_off, valid, in_valid)
        if self.routes(nbr.shape[0], zplan):
            zb, zc = zplan
            return zrun_conv.zrun_conv_sym(x, self.kernel, zb, zc, valid)
        return sparse.sparse_conv_sym(x, nbr, self.kernel, valid)


class DenseStemConv(nn.Module):
    """conv0 as a dense block conv (ops/sparse.conv0_dense_block); the
    ``kernel`` keeps the gathered stem's (k^3, Cin, Cout) layout."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 5):
        super().__init__()
        self.kernel_size = kernel
        self.kernel = _conv_weight(kernel ** 3, in_channels, out_channels)

    def forward(self, dense_in, nbr_win, slot, valid, block: int):
        return sparse.conv0_dense_block(dense_in, nbr_win, slot, self.kernel,
                                        valid, block=block,
                                        kernel=self.kernel_size)


class SparseConvTranspose(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.kernel = _conv_weight(8, in_channels, out_channels)

    def forward(self, x, parent, parent_off, valid, child, in_valid):
        return sparse.sparse_conv_transpose_gf(x, parent, parent_off,
                                               self.kernel, child, valid,
                                               in_valid)


class BasicBlock(nn.Module):
    """conv3 -> BN -> ReLU -> conv3 -> BN -> (+residual) -> ReLU."""

    def __init__(self, in_channels: int, planes: int,
                 bn_momentum: float = 0.02):
        super().__init__()
        self.conv1 = SparseConv(in_channels, planes)
        self.norm1 = MaskedBatchNorm(planes, bn_momentum)
        self.conv2 = SparseConv(planes, planes)
        self.norm2 = MaskedBatchNorm(planes, bn_momentum)
        if in_channels != planes:
            self.downsample_conv = nn.Linear(in_channels, planes, bias=False)
            self.downsample_norm = MaskedBatchNorm(planes, bn_momentum)
        else:
            self.downsample_conv = None

    def forward(self, x, nbr, valid, zplan=None):
        out = F.relu(self.norm1(self.conv1(x, nbr, valid, zplan), valid))
        out = self.norm2(self.conv2(out, nbr, valid, zplan), valid)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_norm(self.downsample_conv(x), valid)
        out = F.relu(out + residual)
        return torch.where(valid[:, None], out, 0)


class ResStage(nn.Module):
    def __init__(self, in_channels: int, planes: int, layers: int,
                 bn_momentum: float = 0.02):
        super().__init__()
        for i in range(layers):
            self.add_module(f"block{i}",
                            BasicBlock(in_channels if i == 0 else planes,
                                       planes, bn_momentum))
        self.layers = layers

    def forward(self, x, nbr, valid, zplan=None):
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x, nbr, valid, zplan)
        return x


class Res16UNet(nn.Module):
    """Res16UNet34C-equivalent sparse U-Net (flat-batch layout).

    ``forward(x (B, P0, Cin), maps)`` with the batched rectangular maps of
    ``data/instseg_pipeline.collate`` returns (out (B, P0, Cout),
    feature_maps) with feature_maps = flat [L4, L3, L2, L1, L0] arrays."""

    def __init__(self, in_channels: int = 3, out_channels: int = 200,
                 init_dim: int = 32,
                 planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
                 conv1_kernel_size: int = 5, pallas_conv: bool = False,
                 bn_momentum: float = 0.02):
        super().__init__()
        P = list(planes)
        self.planes = P
        self.layers = list(layers)
        self.pallas_conv = pallas_conv
        bm = bn_momentum
        self.conv0 = DenseStemConv(in_channels, init_dim, conv1_kernel_size)
        self.bn0 = MaskedBatchNorm(init_dim, bm)
        ch = init_dim
        skip_ch = [init_dim]
        for l in range(4):
            self.add_module(f"conv{l + 1}s2", SparseConv(ch, ch, k=8))
            self.add_module(f"bn{l + 1}", MaskedBatchNorm(ch, bm))
            self.add_module(f"stage{l + 1}",
                            ResStage(ch, P[l], self.layers[l], bm))
            ch = P[l]
            skip_ch.append(ch)
        for i in range(4):
            lvl = 3 - i
            self.add_module(f"convtr{i + 4}", SparseConvTranspose(ch,
                                                                  P[4 + i]))
            self.add_module(f"bntr{i + 4}", MaskedBatchNorm(P[4 + i], bm))
            self.add_module(f"stage{i + 5}",
                            ResStage(P[4 + i] + skip_ch[lvl], P[4 + i],
                                     self.layers[4 + i], bm))
            ch = P[4 + i]
        self.final = nn.Linear(ch, out_channels)

    def stage_levels(self) -> List[Tuple[str, int]]:
        """(stage name, hierarchy level it runs at), encoder then decoder."""
        return ([(f"stage{l + 1}", l + 1) for l in range(4)]
                + [(f"stage{i + 5}", 3 - i) for i in range(4)])

    def routed_convs(self, level_rows: Sequence[int]
                     ) -> List[Tuple[str, int, int, int]]:
        """(name, level, Cin, Cout) of every conv that runs the z-run kernel
        in a forward whose flat levels have ``level_rows`` rows."""
        if not self.pallas_conv:
            return []
        out = []
        for stage, lvl in self.stage_levels():
            if not zrun_conv.applicable(level_rows[lvl], 96, 128):
                continue      # no plan is built at this level
            for name, m in getattr(self, stage).named_modules():
                if isinstance(m, SparseConv) and m.routes(level_rows[lvl],
                                                          zplan=()):
                    out.append((f"{stage}.{name}", lvl, m.kernel.shape[1],
                                m.out_channels))
        return out

    def zrun_plans(self, fm) -> List[Optional[Tuple[torch.Tensor,
                                                    torch.Tensor]]]:
        """Device-built z-run plans for the levels where some 3^3 conv can
        route to the kernel (probed with the (96, 128) channel pair, the
        widest-reach pair of the topology; each conv re-checks its own)."""
        plans = [None] * NUM_LEVELS
        if self.pallas_conv:
            for l in range(NUM_LEVELS):
                n_l = fm[f"valid_{l}"].shape[0]
                if zrun_conv.applicable(n_l, 96, 128):
                    plans[l] = zrun_conv.zrun_plan(fm[f"nbr3_{l}"])
        return plans

    def forward(self, x: torch.Tensor, maps: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        b, p0, _ = x.shape
        fm = flatten_maps(maps)
        v = [fm[f"valid_{l}"] for l in range(NUM_LEVELS)]
        n = [fm[f"nbr3_{l}"] for l in range(NUM_LEVELS)]
        zp = self.zrun_plans(fm)

        out = self.conv0(fm["stem_dense"], fm["stem_nbrblk"], fm["stem_slot"],
                         v[0], fm["stem_block"])
        out = F.relu(self.bn0(out, v[0]))
        skips = [out]
        for l in range(4):
            out = getattr(self, f"conv{l + 1}s2")(
                out, fm[f"child_{l}"], v[l + 1], parent=fm[f"parent_{l}"],
                parent_off=fm[f"parent_off_{l}"], in_valid=v[l])
            out = F.relu(getattr(self, f"bn{l + 1}")(out, v[l + 1]))
            out = getattr(self, f"stage{l + 1}")(out, n[l + 1], v[l + 1],
                                                 zp[l + 1])
            skips.append(out)
        feature_maps = [out]  # L4 (flat)
        for i in range(4):
            lvl = 3 - i
            out = getattr(self, f"convtr{i + 4}")(
                out, fm[f"parent_{lvl}"], fm[f"parent_off_{lvl}"], v[lvl],
                fm[f"child_{lvl}"], v[lvl + 1])
            out = F.relu(getattr(self, f"bntr{i + 4}")(out, v[lvl]))
            out = torch.cat([out, skips[lvl]], -1)
            out = getattr(self, f"stage{i + 5}")(out, n[lvl], v[lvl],
                                                 zp[lvl])
            feature_maps.append(out)
        final = torch.where(v[0][:, None], self.final(out), 0)
        return final.reshape(b, p0, -1), feature_maps
