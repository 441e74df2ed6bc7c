"""PointNet++ set-abstraction encoder (PyTorch); counterpart of
``pq3d_tpu/models/pointnet.py`` (``SharedMLP``, ``PointnetSAModule``,
``PointnetSAModuleMSG``, ``PointNetPP`` and the VoteNet variants
``PointnetSAModuleVotes``, ``PointnetSAModuleMSGVotes``) on
``ops/sampling``: FPS -> ball query -> grouping -> shared MLP -> pool,
ending in a global stage.  The VoteNet variants run the single-cloud
sampling functions on each cloud of the batch.

Input (B, N, 3+C) per-object point clouds (xyz + features), output (B, D).
Submodules carry the flax names (``sa{i}``, ``mlp``, ``dense{j}``,
``bn{j}``) so ``utils/weights.load_flax_variables`` moves a JAX tree.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from pq3d_tpu_torch.models.layers import BatchNorm
from pq3d_tpu_torch.ops import sampling


class SharedMLP(nn.Module):
    """Per-point MLP: (Linear without bias + BatchNorm + ReLU) per width."""

    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        self.n = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f"dense{i}", nn.Linear(in_channels, c,
                                                   bias=False))
            self.add_module(f"bn{i}", BatchNorm(c))
            in_channels = c

    def forward(self, x):
        for i in range(self.n):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"dense{i}")(x)))
        return x


class PointnetSAModule(nn.Module):
    """One set-abstraction stage; ``npoint=None`` is the global stage (all
    points in one group, one max-pool)."""

    def __init__(self, in_feats: int, mlp: Sequence[int],
                 npoint: Optional[int] = None, radius: float = 0.2,
                 nsample: int = 32, use_xyz: bool = True):
        super().__init__()
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.use_xyz = use_xyz
        self.mlp = SharedMLP(in_feats + (3 if use_xyz else 0), mlp)

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor]):
        if self.npoint is not None:
            idx = sampling.furthest_point_sample_batched(xyz, self.npoint)
            centers = sampling.gather_centers_batched(xyz, idx)
            grouped = sampling.query_and_group_batched(
                xyz, centers, feats, self.radius, self.nsample,
                self.use_xyz)                          # (B, M, S, C')
        else:
            centers = xyz.new_zeros(xyz.shape[0], 1, 3)
            if feats is None:
                grouped = xyz[:, None]
            elif self.use_xyz:
                grouped = torch.cat([xyz, feats], -1)[:, None]
            else:
                grouped = feats[:, None]               # (B, 1, N, C')
        return centers, self.mlp(grouped).amax(2)


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale grouping: one FPS center set grouped at several
    (radius, nsample) scales, each through its own shared MLP, features
    concatenated across scales."""

    def __init__(self, in_feats: int, mlps: Sequence[Sequence[int]],
                 npoint: int = 128, radii: Sequence[float] = (0.2, 0.4),
                 nsamples: Sequence[int] = (16, 32), use_xyz: bool = True):
        super().__init__()
        if not len(mlps) == len(radii) == len(nsamples):
            raise ValueError(
                f"MSG scale specs disagree: {len(mlps)} mlps, "
                f"{len(radii)} radii, {len(nsamples)} nsamples")
        self.npoint = npoint
        self.radii = list(radii)
        self.nsamples = list(nsamples)
        self.use_xyz = use_xyz
        for i, mlp in enumerate(mlps):
            self.add_module(f"mlp{i}", SharedMLP(
                in_feats + (3 if use_xyz else 0), mlp))

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor]):
        idx = sampling.furthest_point_sample_batched(xyz, self.npoint)
        centers = sampling.gather_centers_batched(xyz, idx)
        outs = []
        for i, (r, ns) in enumerate(zip(self.radii, self.nsamples)):
            grouped = sampling.query_and_group_batched(
                xyz, centers, feats, r, ns, self.use_xyz)
            outs.append(getattr(self, f"mlp{i}")(grouped).amax(2))
        return centers, torch.cat(outs, -1)


class PointNetPP(nn.Module):
    """Three SA stages with the fixed spec: 32 / 16 / global points, radii
    0.2 / 0.4, MLPs ending at 768.  (B, N, 3+C) -> (B, sa_mlps[-1][-1])."""

    def __init__(self, in_feats: int = 3,
                 sa_n_points: Sequence[Optional[int]] = (32, 16, None),
                 sa_n_samples: Sequence[int] = (32, 32, 32),
                 sa_radii: Sequence[float] = (0.2, 0.4, 100.0),
                 sa_mlps: Sequence[Sequence[int]] = (
                     (64, 64, 128), (128, 128, 256), (256, 512, 768))):
        super().__init__()
        self.n_stages = len(sa_mlps)
        self.out_channels = sa_mlps[-1][-1]
        for i, (np_, ns, r, mlp) in enumerate(zip(
                sa_n_points, sa_n_samples, sa_radii, sa_mlps)):
            self.add_module(f"sa{i}", PointnetSAModule(
                in_feats, mlp, npoint=np_, radius=r, nsample=ns))
            in_feats = mlp[-1]

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        xyz = pts[..., :3].contiguous()
        feats = pts[..., 3:] if pts.shape[-1] > 3 else None
        for i in range(self.n_stages):
            xyz, feats = getattr(self, f"sa{i}")(xyz, feats)
        return feats[:, 0, :]


def _per_cloud(fn, *batched):
    """``fn`` on each cloud of the batched arguments, stacked."""
    return torch.stack([fn(*(a[i] for a in batched))
                        for i in range(batched[0].shape[0])])


def _fps_inds(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    return _per_cloud(lambda x: sampling.furthest_point_sample(x, npoint),
                      xyz)


class PointnetSAModuleVotes(nn.Module):
    """VoteNet set abstraction: FPS indices returned (or given as
    ``inds``), max / avg / rbf pooling, optionally radius-normalised local
    xyz.  Returns ``(new_xyz (B, M, 3), new_feats (B, M, C_out), inds (B,
    M))`` and with ``ret_unique_cnt`` also each center's count of distinct
    grouped points (the ball query fills its ragged tail with the first
    hit)."""

    def __init__(self, in_feats: int, mlp: Sequence[int], npoint: int = 256,
                 radius: float = 0.3, nsample: int = 16,
                 use_xyz: bool = True, pooling: str = "max",
                 sigma: Optional[float] = None, normalize_xyz: bool = False,
                 ret_unique_cnt: bool = False):
        super().__init__()
        if pooling not in ("max", "avg", "rbf"):
            raise NotImplementedError(f"pooling {pooling!r}")
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.use_xyz = use_xyz
        self.pooling = pooling
        self.sigma = radius / 2 if sigma is None else sigma
        self.normalize_xyz = normalize_xyz
        self.ret_unique_cnt = ret_unique_cnt
        # without features the grouped xyz alone feed the MLP
        self.mlp = SharedMLP(in_feats + 3 if use_xyz or not in_feats
                             else in_feats, mlp)

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor],
                inds: Optional[torch.Tensor] = None):
        if inds is None:
            inds = _fps_inds(xyz, self.npoint)
        new_xyz = sampling.gather_centers_batched(xyz, inds)
        idx = _per_cloud(lambda x, c: sampling.ball_query(
            x, c, self.radius, self.nsample), xyz, new_xyz)   # (B, M, S)
        grouped_xyz = _per_cloud(sampling.group_points, xyz, idx) \
            - new_xyz[:, :, None, :]
        if self.normalize_xyz:
            grouped_xyz = grouped_xyz / self.radius
        grouped = grouped_xyz
        if feats is not None:
            gf = _per_cloud(sampling.group_points, feats, idx)
            grouped = torch.cat([grouped_xyz, gf], -1) if self.use_xyz \
                else gf
        h = self.mlp(grouped)
        if self.pooling == "max":
            pooled = h.amax(2)
        elif self.pooling == "avg":
            pooled = h.mean(2)
        else:
            rbf = torch.exp(-grouped_xyz.square().sum(-1)
                            / (self.sigma ** 2) / 2)          # (B, M, S)
            pooled = (h * rbf[..., None]).sum(2) / float(self.nsample)
        if not self.ret_unique_cnt:
            return new_xyz, pooled, inds
        srt = torch.sort(idx, dim=-1).values
        uniq = 1 + (srt[..., 1:] != srt[..., :-1]).sum(-1)
        return new_xyz, pooled, inds, uniq.to(torch.int32)


class PointnetSAModuleMSGVotes(nn.Module):
    """Multi-scale VoteNet set abstraction: one (optionally given) FPS
    index set, per scale a grouping and its MLP, max-pooled and
    concatenated across scales; the indices returned."""

    def __init__(self, in_feats: int, mlps: Sequence[Sequence[int]],
                 npoint: int = 256, radii: Sequence[float] = (0.2, 0.4),
                 nsamples: Sequence[int] = (16, 32), use_xyz: bool = True):
        super().__init__()
        if not len(mlps) == len(radii) == len(nsamples):
            raise ValueError(
                f"MSG scale specs disagree: {len(mlps)} mlps, "
                f"{len(radii)} radii, {len(nsamples)} nsamples")
        self.npoint = npoint
        self.radii = list(radii)
        self.nsamples = list(nsamples)
        self.use_xyz = use_xyz
        for i, mlp in enumerate(mlps):
            self.add_module(f"mlp{i}", SharedMLP(
                in_feats + 3 if use_xyz or not in_feats else in_feats, mlp))

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor],
                inds: Optional[torch.Tensor] = None):
        if inds is None:
            inds = _fps_inds(xyz, self.npoint)
        new_xyz = sampling.gather_centers_batched(xyz, inds)
        outs = []
        for i, (r, ns) in enumerate(zip(self.radii, self.nsamples)):
            if feats is None:
                grouped = _per_cloud(lambda x, c: sampling.query_and_group(
                    x, c, None, r, ns, self.use_xyz), xyz, new_xyz)
            else:
                grouped = _per_cloud(lambda x, c, f: sampling.query_and_group(
                    x, c, f, r, ns, self.use_xyz), xyz, new_xyz, feats)
            outs.append(getattr(self, f"mlp{i}")(grouped).amax(2))
        return new_xyz, torch.cat(outs, -1), inds
