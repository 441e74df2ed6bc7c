"""Sparse residual U-Net over kernel maps (PyTorch).

Counterpart of ``pq3d_tpu/models/sparse_unet.py``: the Res16UNet34C
topology -- 5^3 stem -> 4x stride-2 encoder ladder -> 4x transpose-conv
decoder with skip concats -> final 1x1 conv -- where every sparse conv is
a gather -> GEMM over precomputed neighbor maps.  The stem ``conv0`` runs
as a dense conv over the batch's packed blocks where it ships a stem pack
(``stem_dense``, ``stem_mode='dense_block'``), else as the 125-tap gather
conv over ``nbr5_0`` (``stem_mode='gather'``), routed like every other
conv below except that it never takes int8 (the JAX package builds it
without the option).  The batch of scenes runs as one (B*P_l, C) array
per level: ``flatten_maps`` offsets the rectangular layout's per-scene
indices; the flat-pack layout (``data/instseg_pipeline.collate_flat``)
arrives concatenated and offset by the host and passes through.

Routing of a conv, in the JAX package's order (its ``SparseConv``):

1. a tap-compacted plan (the flat pack with ``compact_conv``: the batch's
   ``cmp{l}_*``): ``sparse_conv_compact_sym`` under ``grad_mode
   'scatter_free'``, else ``sparse_conv_compact`` (with ``int8_gather``);
   kernel B1 is off for such a batch, as in JAX;
2. with ``pallas_conv``, a stride-1 3^3 conv whose shape passes
   ``ops/zrun_conv.applicable`` runs the hand-written CUDA kernel over a
   z-run plan (the batch's shipped ``zt{l}_*`` plan where there is one,
   else one built on the device), always with its custom backward and
   never with int8 (the JAX package's Pallas kernel takes neither);
3. where the batch ships a z-run plan (``ztriple_conv``) and the shape
   passes ``ops/sparse.ztriple_applicable``, the z-run gather conv
   (``sparse_conv_ztriple_sym``, or under ``'native'`` autograd through
   ``sparse_conv_ztriple``);
4. under ``'scatter_free'`` the down conv or the symmetric gather conv
   with their custom backward (``sorted_gather`` reads each map through
   ``sorted_conv_maps``);
5. else (``'native'``) autograd through ``sparse_conv``, with
   ``sorted_gather`` and ``int8_gather``.

The transpose convs take the gather-only backward under
``'scatter_free'``, else autograd through ``sparse_conv_transpose`` (with
int8).  ``int8_gather`` holds only outside training (the JAX package's
``int8_gather and not train``), so under ``'scatter_free'`` it changes
nothing.  The predicates of 2 and 3 claim disjoint shapes, so the shipped
plans never change which convs the kernel takes.  The JAX package guards
its windowed kernel with an exception-overflow fallback; the Hopper
kernel has no window, so every routed conv runs the kernel.

``remat_policy`` (training only) checkpoints each BasicBlock, each
stride-2 conv and the gathered stem as the JAX package's
``remat_block_cls`` does, through
``torch.utils.checkpoint``: ``'full'`` recomputes everything, ``'dots'``
saves the matrix products' outputs, ``'gather_only'`` everything but the
gathered rows (``index_select``), ``'none'`` checkpoints nothing.  The
recomputation leaves the batch-norm running statistics alone, so every
policy gives the gradients and statistics of ``'none'``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pq3d_tpu_torch.models import layers
from pq3d_tpu_torch.models.layers import MaskedBatchNorm
from pq3d_tpu_torch.ops import kernel_maps, sparse, zrun_conv

NUM_LEVELS = 5
GRAD_MODES = ("scatter_free", "native")
REMAT_POLICIES = ("none", "full", "dots", "gather_only")


@dataclasses.dataclass(frozen=True)
class ConvOptions:
    """How a forward's convs run: ``grad_mode`` ('scatter_free' or
    'native'), ``sorted_gather`` and ``int8_gather`` (already off in
    training, as the JAX package's ``int8_gather and not train``)."""
    grad_mode: str = "scatter_free"
    sorted_gather: bool = False
    int8_gather: bool = False
    # the forward's monotone maps (ops/sparse.sorted_conv_maps) by the id
    # of their map, computed once for all the convs that read a map
    sorted_idx: Optional[Dict[int, tuple]] = None

    def __post_init__(self):
        if self.grad_mode not in GRAD_MODES:
            raise ValueError(f"grad_mode {self.grad_mode!r} is not one of "
                             f"{GRAD_MODES}")

    def sorted_for(self, nbr: torch.Tensor):
        """A conv's ``sorted_maps`` argument for the map ``nbr``."""
        if not self.sorted_gather:
            return False
        return (self.sorted_idx or {}).get(id(nbr), True)


SCATTER_FREE = ConvOptions()

_SAVED_BY_DOTS = frozenset(
    getattr(torch.ops.aten, name).default
    for name in ("mm", "addmm", "bmm", "baddbmm"))


def _remat_policy(name: str):
    """torch's selective-checkpoint policy for a ``remat_policy`` that
    saves some outputs: 'dots' keeps the matrix products, 'gather_only'
    everything but ``index_select``'s gathered rows.  Ops that write in
    place are recomputed: the tensors they return change under them."""
    from torch.utils.checkpoint import CheckpointPolicy

    def policy(ctx, op, *args, **kwargs):
        if op._schema.is_mutable:
            return CheckpointPolicy.PREFER_RECOMPUTE
        if name == "dots":
            save = op in _SAVED_BY_DOTS
        else:
            save = op != torch.ops.aten.index_select.default
        return (CheckpointPolicy.MUST_SAVE if save
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def remat_call(policy: str, fn, *args):
    """``fn(*args)`` under ``remat_policy`` ``policy`` (not 'none'): the
    first run is the forward; a later run is the backward's recomputation,
    during which ``layers.frozen_running_stats`` keeps the batch norms'
    running statistics from a second update."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    runs = []

    def run(*a):
        runs.append(1)
        if len(runs) == 1:
            return fn(*a)
        with layers.frozen_running_stats():
            return fn(*a)
    kw = {}
    if policy in ("dots", "gather_only"):
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _remat_policy(policy))
    elif policy != "full":
        raise ValueError(f"remat_policy {policy!r} is not one of "
                         f"{REMAT_POLICIES}")
    return checkpoint(run, *args, use_reentrant=False, **kw)


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
    table becomes absolute flat indices per level, and z-run plans get the
    scene offset on every base (a base is never -1: the codes mask it).
    Flat-pack maps (``valid_0`` without a batch dim) pass through.  The
    dense-block stem pack, or the gather stem's ``nbr5_0``, is flattened
    where the batch ships one (a swin batch has neither)."""
    if maps["valid_0"].dim() == 1:
        out = dict(maps)
        if "stem_c2v" in maps:
            out["stem_block"] = round((maps["stem_c2v"].shape[0]
                                       // maps["stem_nbrblk"].shape[0])
                                      ** (1 / 3))
        return out
    out: Dict[str, torch.Tensor] = {}
    off = offset_scene_indices
    b = maps["valid_0"].shape[0]
    for l in range(NUM_LEVELS):
        p_l = maps[f"valid_{l}"].shape[1]
        out[f"valid_{l}"] = maps[f"valid_{l}"].reshape(-1)
        out[f"nbr3_{l}"] = off(maps[f"nbr3_{l}"], p_l)
        if f"zt{l}_base" in maps:
            zb = maps[f"zt{l}_base"]
            shift = (torch.arange(b, dtype=zb.dtype, device=zb.device)
                     * p_l).reshape(b, 1, 1)
            out[f"zt{l}_base"] = (zb + shift).reshape(-1, 9)
            out[f"zt{l}_code"] = maps[f"zt{l}_code"].reshape(-1, 9, 3)
    for l in range(NUM_LEVELS - 1):
        p_l = maps[f"valid_{l}"].shape[1]
        p_next = maps[f"valid_{l + 1}"].shape[1]
        out[f"child_{l}"] = off(maps[f"child_{l}"], p_l)
        out[f"parent_{l}"] = off(maps[f"parent_{l}"], p_next)
        out[f"parent_off_{l}"] = maps[f"parent_off_{l}"].reshape(-1)
    for l in range(NUM_LEVELS):
        p_l = maps[f"valid_{l}"].shape[1]
        out[f"ancestor_{l}"] = off(maps["ancestor"][:, l, :], p_l)
    if "nbr5_0" in maps:
        out["nbr5_0"] = off(maps["nbr5_0"], maps["valid_0"].shape[1])
    if "stem_c2v" not in maps:
        return out
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
    kernel_offsets order (K = 27 stride-1 3^3, K = 8 stride-2 down, K =
    k^3 the stem, whose kernel the dense-block stem reads in the same
    layout)."""

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
                parent_off=None, in_valid=None, ztplan=None,
                opts: ConvOptions = SCATTER_FREE):
        """``nbr`` is the (N, K) map, or a compact plan (a dict); the dual
        maps ``parent``/``parent_off``/``in_valid`` make it a stride-2
        down conv over the child map ``nbr``; ``zplan`` is the kernel's
        z-run plan (None: the kernel is off), ``ztplan`` the batch's
        shipped plan for the z-run gather conv; ``opts`` the forward's
        ConvOptions.  Routing: the module docstring."""
        w = self.kernel
        sf = opts.grad_mode == "scatter_free"
        i8 = opts.int8_gather
        if isinstance(nbr, dict):
            if sf:
                return sparse.sparse_conv_compact_sym(x, nbr, w, valid)
            return sparse.sparse_conv_compact(x, nbr, w, valid,
                                              int8_gather=i8)
        if parent is None and self.routes(nbr.shape[0], zplan):
            zb, zc = zplan
            return zrun_conv.zrun_conv_sym(x, w, zb, zc, valid)
        if (parent is None and ztplan is not None and w.shape[0] == 27
                and sparse.ztriple_applicable(nbr.shape[0], w.shape[1],
                                              self.out_channels)):
            zb, zc = ztplan
            if sf:
                return sparse.sparse_conv_ztriple_sym(x, zb, zc, w, valid)
            return sparse.sparse_conv_ztriple(x, zb, zc, w, valid)
        sg = opts.sorted_for(nbr)
        if sf and parent is not None:
            return sparse.sparse_conv_down(x, nbr, w, parent, parent_off,
                                           valid, in_valid, sorted_maps=sg)
        if sf:
            return sparse.sparse_conv_sym(x, nbr, w, valid, sorted_maps=sg)
        return sparse.sparse_conv(x, nbr, w, None, valid, sorted_maps=sg,
                                  int8_gather=i8)


class SparseConvTranspose(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.kernel = _conv_weight(8, in_channels, out_channels)

    def forward(self, x, parent, parent_off, valid, child, in_valid,
                opts: ConvOptions = SCATTER_FREE):
        if opts.grad_mode == "scatter_free":
            return sparse.sparse_conv_transpose_gf(
                x, parent, parent_off, self.kernel, child, valid, in_valid,
                sorted_maps=opts.sorted_for(child))
        return sparse.sparse_conv_transpose(x, parent, parent_off,
                                            self.kernel, valid,
                                            int8_gather=opts.int8_gather)


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

    def forward(self, x, nbr, valid, zplan=None, ztplan=None,
                opts: ConvOptions = SCATTER_FREE):
        out = F.relu(self.norm1(self.conv1(x, nbr, valid, zplan,
                                           ztplan=ztplan, opts=opts), valid))
        out = self.norm2(self.conv2(out, nbr, valid, zplan, ztplan=ztplan,
                                    opts=opts), valid)
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

    def forward(self, x, nbr, valid, zplan=None, ztplan=None,
                opts: ConvOptions = SCATTER_FREE, remat: str = "none"):
        """``remat`` (a remat_policy) checkpoints each block."""
        for i in range(self.layers):
            block = getattr(self, f"block{i}")
            if remat == "none":
                x = block(x, nbr, valid, zplan, ztplan, opts)
            else:
                x = remat_call(remat, functools.partial(
                    block, nbr=nbr, valid=valid, zplan=zplan, ztplan=ztplan,
                    opts=opts), x)
        return x


class Res16UNet(nn.Module):
    """Res16UNet34C-equivalent sparse U-Net (flat-batch layout).

    ``forward(x (B, P0, Cin), maps)`` with the batched rectangular maps of
    ``data/instseg_pipeline.collate`` returns (out (B, P0, Cout),
    feature_maps) with feature_maps = flat [L4, L3, L2, L1, L0] arrays;
    with the flat-pack maps of ``collate_flat``, ``x`` is (N, Cin) (padded
    to the level-0 total here) and ``out`` (1, P0, Cout).  ``grad_mode``,
    ``remat_policy``, ``sorted_gather``, ``int8_gather`` and
    ``pallas_conv`` are attributes a caller may change between forwards
    (routing: the module docstring)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 200,
                 init_dim: int = 32,
                 planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
                 conv1_kernel_size: int = 5, pallas_conv: bool = False,
                 bn_momentum: float = 0.02,
                 grad_mode: str = "scatter_free",
                 remat_policy: str = "none", sorted_gather: bool = False,
                 int8_gather: bool = False):
        super().__init__()
        P = list(planes)
        self.planes = P
        self.layers = list(layers)
        self.pallas_conv = pallas_conv
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r} is not one of "
                             f"{REMAT_POLICIES}")
        ConvOptions(grad_mode)             # checks the mode
        self.grad_mode = grad_mode
        self.remat_policy = remat_policy
        self.sorted_gather = sorted_gather
        self.int8_gather = int8_gather
        bm = bn_momentum
        self.conv1_kernel_size = conv1_kernel_size
        self.conv0 = SparseConv(in_channels, init_dim,
                                k=conv1_kernel_size ** 3)
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
        # channels of the feature maps [L4, L3, L2, L1, L0]: the encoder's
        # last stage, then the four decoder stages
        self.feature_channels = [P[3]] + P[4:8]

    def stage_levels(self) -> List[Tuple[str, int]]:
        """(stage name, hierarchy level it runs at), encoder then decoder."""
        return ([(f"stage{l + 1}", l + 1) for l in range(4)]
                + [(f"stage{i + 5}", 3 - i) for i in range(4)])

    def routed_convs(self, level_rows: Sequence[int], compact: bool = False
                     ) -> List[Tuple[str, int, int, int]]:
        """(name, level, Cin, Cout) of every conv that runs the z-run kernel
        in a forward whose flat levels have ``level_rows`` rows (none for
        a batch with compact plans, ``compact``)."""
        if not self.pallas_conv or compact:
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
        """The kernel's z-run plan per level, for the levels where some 3^3
        conv can route to it (probed with the (96, 128) channel pair, the
        widest-reach pair of the topology; each conv re-checks its own):
        the batch's shipped ``zt{l}_*`` plan where there is one (the same
        plan, bit for bit), else one built on the device.  None at every
        level for a batch with compact plans, as in JAX."""
        plans = [None] * NUM_LEVELS
        if self.pallas_conv and "cmp0_in" not in fm:
            for l in range(NUM_LEVELS):
                n_l = fm[f"valid_{l}"].shape[0]
                if zrun_conv.applicable(n_l, 96, 128):
                    plans[l] = ((fm[f"zt{l}_base"], fm[f"zt{l}_code"])
                                if f"zt{l}_base" in fm
                                else zrun_conv.zrun_plan(fm[f"nbr3_{l}"]))
        return plans

    def forward(self, x: torch.Tensor, maps: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        fm = flatten_maps(maps)
        v = [fm[f"valid_{l}"] for l in range(NUM_LEVELS)]
        if "cmp0_in" in fm:
            n = [{key: fm[f"cmp{l}_{short}"]
                  for short, key in kernel_maps.COMPACT_MAP_KEYS}
                 for l in range(NUM_LEVELS)]
        else:
            n = [fm[f"nbr3_{l}"] for l in range(NUM_LEVELS)]
        zp = self.zrun_plans(fm)
        sorted_idx = None
        if self.sorted_gather:
            sorted_idx = {id(t): sparse.sorted_conv_maps(t) for t in
                          [m for m in n if not isinstance(m, dict)]
                          + [fm[f"child_{l}"] for l in range(4)]
                          + ([fm["nbr5_0"]] if "nbr5_0" in fm else [])}
        opts = ConvOptions(self.grad_mode, self.sorted_gather,
                           self.int8_gather and not self.training,
                           sorted_idx)
        remat = self.remat_policy if self.training else "none"
        zt = [(fm[f"zt{l}_base"], fm[f"zt{l}_code"])
              if f"zt{l}_base" in fm else None for l in range(NUM_LEVELS)]
        if x.dim() == 2:               # flat pack: (N, Cin), N <= P0
            b, p0 = 1, v[0].shape[0]
            x = F.pad(x, (0, 0, 0, p0 - x.shape[0]))
        else:
            b, p0, _ = x.shape

        if "stem_dense" in fm:
            out = sparse.conv0_dense_block(
                fm["stem_dense"], fm["stem_nbrblk"], fm["stem_slot"],
                self.conv0.kernel, v[0], block=fm["stem_block"],
                kernel=self.conv1_kernel_size)
        else:
            stem = functools.partial(
                self.conv0, nbr=fm["nbr5_0"], valid=v[0],
                opts=dataclasses.replace(opts, int8_gather=False))
            x0 = x.reshape(b * p0, -1)
            out = stem(x0) if remat == "none" else remat_call(remat, stem,
                                                               x0)
        out = F.relu(self.bn0(out, v[0]))
        skips = [out]
        for l in range(4):
            down = functools.partial(
                getattr(self, f"conv{l + 1}s2"), nbr=fm[f"child_{l}"],
                valid=v[l + 1], parent=fm[f"parent_{l}"],
                parent_off=fm[f"parent_off_{l}"], in_valid=v[l], opts=opts)
            out = down(out) if remat == "none" else \
                remat_call(remat, down, out)
            out = F.relu(getattr(self, f"bn{l + 1}")(out, v[l + 1]))
            out = getattr(self, f"stage{l + 1}")(out, n[l + 1], v[l + 1],
                                                 zp[l + 1], zt[l + 1], opts,
                                                 remat)
            skips.append(out)
        feature_maps = [out]  # L4 (flat)
        for i in range(4):
            lvl = 3 - i
            out = getattr(self, f"convtr{i + 4}")(
                out, fm[f"parent_{lvl}"], fm[f"parent_off_{lvl}"], v[lvl],
                fm[f"child_{lvl}"], v[lvl + 1], opts)
            out = F.relu(getattr(self, f"bntr{i + 4}")(out, v[lvl]))
            out = torch.cat([out, skips[lvl]], -1)
            out = getattr(self, f"stage{i + 5}")(out, n[lvl], v[lvl],
                                                 zp[lvl], zt[lvl], opts,
                                                 remat)
            feature_maps.append(out)
        final = torch.where(v[0][:, None], self.final(out), 0)
        return final.reshape(b, p0, -1), feature_maps
