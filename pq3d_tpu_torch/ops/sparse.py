"""Device-side sparse convolution: gather -> GEMM -> accumulate (PyTorch).

Counterpart of ``pq3d_tpu/ops/sparse.py`` (forward only).  Every conv is a
row gather over a host-built neighbor map (ops/kernel_maps): for output
voxel ``j`` and kernel offset ``k``, ``nbr[j, k]`` indexes the contributing
input voxel (-1 = missing)::

    out[j] = sum_k  valid(nbr[j,k]) * x[nbr[j,k]] @ W[k]

Numerics follow the JAX package: operands are rounded to ``compute_dtype``
(bf16 by default) and products accumulate in f32.  The plain versions here
emulate that exactly by rounding to bf16 and multiplying in f32 (a bf16
value is exact in f32), so they agree with the JAX functions up to
summation order on any device.  Functions take flat (N, C) inputs; the
batch is flattened by ``models/sparse_unet.flatten_maps``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _round(t: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Round to ``compute_dtype`` and return f32 (exact for bf16/f16/f32)."""
    return t.to(compute_dtype).float()


def fast_row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of (N, C) ``x`` at in-bounds indices ``idx``."""
    return x.index_select(0, idx)


def _masked_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows at ``idx``; rows where ``idx < 0`` are zero."""
    rows = x.index_select(0, idx.clamp_min(0))
    return torch.where((idx >= 0)[:, None], rows, 0)


def ztriple_applicable(n_rows: int, cin: int, cout: int) -> bool:
    """The JAX package's z-run gather predicate
    (pq3d_tpu/ops/sparse.ztriple_applicable), kept verbatim because the
    routing of ops/zrun_conv excludes the shapes it claims: C <= 64
    anywhere, and 64 < C < 256 while N * C <= 5e6."""
    c = max(cin, cout)
    if c >= 256:
        return False
    if c <= 64:
        return True
    return n_rows * c <= 5_000_000


def sparse_conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_valid: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Sparse convolution via gather -> GEMM (plain PyTorch).

    Args:
      x:    (N_in, Cin) voxel features (padded rows zero).
      nbr:  (N_out, K) int neighbor map, -1 for missing.
      w:    (K, Cin, Cout) kernel weights.
      bias: optional (Cout,).
      out_valid: optional (N_out,) bool mask; invalid rows are zeroed.
    Returns: (N_out, Cout) in x.dtype.  The forward of the JAX package's
    ``sparse_conv_sym`` and ``sparse_conv_down`` is this function.
    """
    xb = _round(x, compute_dtype)
    wb = _round(w, compute_dtype)
    acc = torch.zeros(nbr.shape[0], w.shape[-1], dtype=torch.float32,
                      device=x.device)
    for k in range(nbr.shape[1]):
        acc.addmm_(_masked_gather(xb, nbr[:, k]), wb[k])
    if bias is not None:
        acc = acc + bias
    if out_valid is not None:
        acc = torch.where(out_valid[:, None], acc, 0)
    return acc.to(x.dtype)


def sparse_conv_transpose(x: torch.Tensor, parent: torch.Tensor,
                          parent_off: torch.Tensor, w: torch.Tensor,
                          out_valid: Optional[torch.Tensor] = None,
                          compute_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """Stride-2 transposed (upsampling) convolution, kernel 2^3.

    Each fine voxel has one coarse parent and a kernel offset id, so the
    8 GEMMs run on the coarse level and one gather picks each fine row.

    Args:
      x:          (N_coarse, Cin) coarse features.
      parent:     (N_fine,) int parent index, -1 for pads.
      parent_off: (N_fine,) int kernel offset id in [0, 8).
      w:          (8, Cin, Cout).
    Returns: (N_fine, Cout) in x.dtype.
    """
    n_coarse = x.shape[0]
    y = torch.einsum("nc,kcd->knd", _round(x, compute_dtype),
                     _round(w, compute_dtype))        # (8, Nc, Cout) f32
    y = y.reshape(8 * n_coarse, -1)
    flat = parent_off.long() * n_coarse + parent.clamp_min(0).long()
    out = fast_row_gather(y, flat)
    out = torch.where((parent >= 0)[:, None], out, 0)
    if out_valid is not None:
        out = torch.where(out_valid[:, None], out, 0)
    return out.to(x.dtype)


def conv0_dense_block(dense_in: torch.Tensor, nbr_win: torch.Tensor,
                      slot: torch.Tensor, w: torch.Tensor,
                      out_valid: Optional[torch.Tensor] = None,
                      block: int = 8, kernel: int = 5,
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """Stem convolution as a dense conv over packed ``block^3`` cells.

    The JAX package runs this as XLA ``conv_general_dilated`` on halo
    blocks; here each block gathers its halo from the 27 neighbouring
    blocks and ``F.conv3d`` runs the 5^3 conv (both are cross-correlation,
    so the weights only change layout).  The output is rounded to
    ``compute_dtype`` like the JAX version's.

    Args:
      dense_in: (NB, block^3 * Cin) packed blocks, empty cells zero.
      nbr_win:  (NB, 27) neighbor block ids (kernel_offsets(3) order, -1
                missing; center tap = the block itself).
      slot:     (N,) flat cell index per voxel (-1 padded voxel).
      w:        (kernel^3, Cin, Cout) in kernel_offsets(kernel) order.
    Returns: (N, Cout) in dense_in.dtype.
    """
    p = kernel // 2
    nb = dense_in.shape[0]
    cin = dense_in.shape[1] // block ** 3
    cout = w.shape[-1]
    h = block + 2 * p
    xb = _round(dense_in, compute_dtype)
    halo = torch.zeros(nb, h, h, h, cin, dtype=xb.dtype, device=xb.device)
    # src/dst slice per axis offset: o=-1 -> src [block-p, block) dst [0, p)
    ax = {-1: (block - p, p, 0), 0: (0, block, p), 1: (0, p, p + block)}
    t = 0
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                src = _masked_gather(xb, nbr_win[:, t])
                src = src.reshape(nb, block, block, block, cin)
                (sx, lx, dx), (sy, ly, dy), (sz, lz, dz) = \
                    ax[ox], ax[oy], ax[oz]
                halo[:, dx:dx + lx, dy:dy + ly, dz:dz + lz, :] = \
                    src[:, sx:sx + lx, sy:sy + ly, sz:sz + lz, :]
                t += 1
    # (k^3, Cin, Cout) z-fastest -> conv3d's (Cout, Cin, kx, ky, kz)
    w5 = _round(w, compute_dtype).reshape(kernel, kernel, kernel, cin, cout)
    w5 = w5.permute(4, 3, 0, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv3d(halo.permute(0, 4, 1, 2, 3), w5)   # (NB, Cout, b, b, b)
    y = y.permute(0, 2, 3, 4, 1).reshape(nb * block ** 3, cout)
    y = _round(y, compute_dtype)
    out = _masked_gather(y, slot)
    if out_valid is not None:
        out = torch.where(out_valid[:, None], out, 0)
    return out.to(dense_in.dtype)
