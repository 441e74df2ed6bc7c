"""Coordinate positional encodings; counterpart of
``pq3d_tpu/models/posembed.py``."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from pq3d_tpu_torch.models.layers import FLAX_LN_EPS


def shift_scale_points(xyz: torch.Tensor,
                       src_range: Tuple[torch.Tensor, torch.Tensor]
                       ) -> torch.Tensor:
    """Normalize (B, N, 3) points from [min, max] to [0, 1] per batch."""
    lo, hi = src_range
    diff = (hi - lo).clamp_min(1e-6)
    return (xyz - lo[:, None, :]) / diff[:, None, :]


class FourierPositionEncoding(nn.Module):
    """Gaussian Fourier features of 3D coordinates -> d_pos channels; the
    projection ``gauss_B`` is a fixed buffer drawn at init."""

    def __init__(self, d_pos: int, d_in: int = 3, gauss_scale: float = 1.0,
                 normalize: bool = True):
        super().__init__()
        assert d_pos % 2 == 0
        self.normalize = normalize
        self.gauss_scale = gauss_scale
        self.register_buffer("gauss_B", torch.zeros(d_in, d_pos // 2))

    def forward(self, xyz: torch.Tensor,
                input_range: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        x = xyz.float()
        if self.normalize and input_range is not None:
            x = shift_scale_points(x, input_range)
        x = x * (2 * math.pi)
        proj = torch.einsum("bnd,df->bnf", x, self.gauss_B)
        out = torch.cat([torch.sin(proj), torch.cos(proj)], -1)
        return out.to(xyz.dtype)


class CoordinateEncoder(nn.Module):
    """Fourier PE + Linear/LayerNorm projection."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.pos_enc = FourierPositionEncoding(hidden_size)
        self.Dense_0 = nn.Linear(hidden_size, hidden_size)
        self.LayerNorm_0 = nn.LayerNorm(hidden_size, eps=FLAX_LN_EPS)

    def forward(self, coords, input_range=None):
        return self.LayerNorm_0(self.Dense_0(self.pos_enc(coords,
                                                          input_range)))
