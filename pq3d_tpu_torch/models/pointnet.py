"""PointNet++ set-abstraction encoder (PyTorch); counterpart of
``pq3d_tpu/models/pointnet.py`` (``SharedMLP``, ``PointnetSAModule``,
``PointnetSAModuleMSG``, ``PointNetPP``) on ``ops/sampling``: FPS -> ball
query -> grouping -> shared MLP -> max-pool, ending in a global stage.

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
