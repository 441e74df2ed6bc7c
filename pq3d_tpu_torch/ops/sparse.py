"""Device-side sparse convolution: gather -> GEMM -> accumulate (PyTorch).

Counterpart of ``pq3d_tpu/ops/sparse.py``.  Every conv is a row gather
over a host-built neighbor map (ops/kernel_maps): for output voxel ``j``
and kernel offset ``k``, ``nbr[j, k]`` indexes the contributing input voxel
(-1 = missing)::

    out[j] = sum_k  valid(nbr[j,k]) * x[nbr[j,k]] @ W[k]

Numerics follow the JAX package: operands are rounded to ``compute_dtype``
(bf16 by default) and products accumulate in f32.  The plain versions here
emulate that exactly by rounding to bf16 and multiplying in f32 (a bf16
value is exact in f32), so they agree with the JAX functions up to
summation order on any device.  Functions take flat (N, C) inputs; the
batch is flattened by ``models/sparse_unet.flatten_maps``.

Training uses the scatter-free convs of the JAX package (its custom VJPs):
every map has an exact transpose map, so ``dx`` is another gather-GEMM
conv and ``dW`` re-gathers the input.  Each is an ``autograd.Function``
that saves only its input, W and the maps, never the K x N x Cin gathered
taps that plain autograd through :func:`sparse_conv` would keep.  Like
the JAX VJPs they round ``x`` and ``dy`` to ``compute_dtype`` and
accumulate ``dW`` in f32.
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


def _stem_halo(dense_in: torch.Tensor, nbr_win: torch.Tensor, block: int,
               kernel: int, compute_dtype: torch.dtype) -> torch.Tensor:
    """(NB, h, h, h, Cin) channels-last halo blocks, h = block +
    2*(kernel//2): each block with the border cells of its 26 neighbours,
    rounded to ``compute_dtype`` (held in f32)."""
    p = kernel // 2
    nb = dense_in.shape[0]
    cin = dense_in.shape[1] // block ** 3
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
    return halo


def _stem_weight_grad(halo: torch.Tensor, g: torch.Tensor, kernel: int,
                      rows_per_chunk: int = 1 << 18) -> torch.Tensor:
    """dW (k^3, Cin, Cout) f32 of the stem's halo conv: each cell's k^3 x
    Cin patch (unfolded from the channels-last halo) times its output
    gradient ``g`` (NB*b^3, Cout), one f32 GEMM per chunk of blocks so
    the patches of about ``rows_per_chunk`` cells exist at a time.  (A
    cuDNN weight-gradient conv of a 3-channel 5^3 stem runs a direct
    kernel that is far slower than this one GEMM.)"""
    nb, h, _, _, cin = halo.shape
    b3 = (h - kernel + 1) ** 3
    cout = g.shape[-1]
    g = g.reshape(nb, b3, cout)
    step = max(1, rows_per_chunk // b3)
    dw = torch.zeros(kernel ** 3 * cin, cout, dtype=torch.float32,
                     device=g.device)
    for s in range(0, nb, step):
        u = halo[s:s + step].unfold(1, kernel, 1).unfold(2, kernel, 1) \
            .unfold(3, kernel, 1)            # (n, b, b, b, Cin, kx, ky, kz)
        patches = u.permute(0, 1, 2, 3, 5, 6, 7, 4).reshape(
            -1, kernel ** 3 * cin)
        dw.addmm_(patches.t(), g[s:s + step].reshape(-1, cout).float())
    return dw.reshape(kernel ** 3, cin, cout)


def _conv3d_layout(w: torch.Tensor, kernel: int) -> torch.Tensor:
    """(k^3, Cin, Cout) z-fastest -> conv3d's (Cout, Cin, kx, ky, kz)."""
    cin, cout = w.shape[1], w.shape[2]
    return w.reshape(kernel, kernel, kernel, cin, cout).permute(4, 3, 0, 1, 2)


class _StemConv(torch.autograd.Function):
    """The stem's halo conv with the JAX package's ``halo_bwd``: only dW,
    because the stem's input is data.  Saves the packed input and the block
    map and rebuilds the halo in the backward."""

    @staticmethod
    def forward(ctx, dense_in, nbr_win, w, block, kernel, compute_dtype):
        if ctx.needs_input_grad[0]:
            raise NotImplementedError("the stem conv has no input gradient "
                                      "(its input is data)")
        ctx.save_for_backward(dense_in, nbr_win)
        ctx.conf = (block, kernel, compute_dtype, w.shape)
        halo = _stem_halo(dense_in, nbr_win, block, kernel, compute_dtype)
        w5 = _conv3d_layout(_round(w, compute_dtype), kernel)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y = F.conv3d(halo.permute(0, 4, 1, 2, 3), w5)  # (NB, Cout, b^3)
        cout = w.shape[-1]
        y = y.permute(0, 2, 3, 4, 1).reshape(-1, cout)
        return _round(y, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        dense_in, nbr_win = ctx.saved_tensors
        block, kernel, compute_dtype, wshape = ctx.conf
        halo = _stem_halo(dense_in, nbr_win, block, kernel, compute_dtype)
        dw = _stem_weight_grad(halo, _round(g, compute_dtype), kernel)
        # the JAX VJP differentiates a compute_dtype conv, so its dW comes
        # out rounded to compute_dtype
        return None, None, _round(dw, compute_dtype), None, None, None


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
    ``compute_dtype`` like the JAX version's.  The per-cell rows go back
    to voxels by a gather through ``slot``, whose backward is autograd's
    ``index_add`` (slot is one-to-one, so no two voxels add into a cell).

    Args:
      dense_in: (NB, block^3 * Cin) packed blocks, empty cells zero.
      nbr_win:  (NB, 27) neighbor block ids (kernel_offsets(3) order, -1
                missing; center tap = the block itself).
      slot:     (N,) flat cell index per voxel (-1 padded voxel).
      w:        (kernel^3, Cin, Cout) in kernel_offsets(kernel) order.
    Returns: (N, Cout) in dense_in.dtype.
    """
    y = _StemConv.apply(dense_in, nbr_win, w, block, kernel, compute_dtype)
    out = _masked_gather(y, slot)
    if out_valid is not None:
        out = torch.where(out_valid[:, None], out, 0)
    return out.to(dense_in.dtype)


def _mask_rows(dy: torch.Tensor, valid: Optional[torch.Tensor]
               ) -> torch.Tensor:
    return dy if valid is None else torch.where(valid[:, None], dy, 0)


def conv_weight_grad(x: torch.Tensor, nbr: torch.Tensor, dy: torch.Tensor,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """dW[k] = gather(x, nbr[:, k])^T @ dy, one GEMM per tap on operands
    rounded to ``compute_dtype``, f32 accumulation (re-gathers instead of
    using stored activations)."""
    xb = _round(x, compute_dtype)
    dyb = _round(dy, compute_dtype)
    return torch.stack([_masked_gather(xb, nbr[:, k]).t() @ dyb
                        for k in range(nbr.shape[1])])


def _offset_weight_grad(xs: torch.Tensor, dys: torch.Tensor,
                        parent_off: torch.Tensor, k: int) -> torch.Tensor:
    """dW[k] = sum over fine rows with offset k of xs^T dys (stride-2
    convs: one GEMM per offset on the row-aligned fine operands)."""
    return torch.stack([torch.where((parent_off == i)[:, None], xs, 0).t()
                        @ dys for i in range(k)])


class _SparseConvSym(torch.autograd.Function):
    """Same-level symmetric-stencil conv: for lexicographic odd offsets
    tap K-1-k is the negated offset of tap k, so dx = conv(dy, nbr,
    flip_k(W)^T)."""

    @staticmethod
    def forward(ctx, x, w, nbr, out_valid):
        ctx.save_for_backward(x, w, nbr, out_valid)
        return sparse_conv(x, nbr, w, None, out_valid)

    @staticmethod
    def backward(ctx, dy):
        x, w, nbr, out_valid = ctx.saved_tensors
        dy = _mask_rows(dy, out_valid)
        dx = sparse_conv(dy, nbr, w.flip(0).transpose(1, 2)).to(x.dtype)
        dw = conv_weight_grad(x, nbr, dy).to(w.dtype)
        return dx, dw, None, None


class _SparseConvDown(torch.autograd.Function):
    """Stride-2 down conv over the child map; the transpose runs through
    the dual parent/parent_off maps."""

    @staticmethod
    def forward(ctx, x, w, child, parent, parent_off, out_valid, in_valid):
        ctx.save_for_backward(x, w, parent, parent_off, out_valid, in_valid)
        return sparse_conv(x, child, w, None, out_valid)

    @staticmethod
    def backward(ctx, dy):
        x, w, parent, parent_off, out_valid, in_valid = ctx.saved_tensors
        dy = _mask_rows(dy, out_valid)
        dx = sparse_conv_transpose(dy, parent, parent_off, w.transpose(1, 2),
                                   in_valid).to(x.dtype)
        # one gather of dy through the parent map, then one masked GEMM per
        # offset (instead of 8 gathers of x through the child map)
        dyg = _masked_gather(_round(dy, torch.bfloat16), parent)
        dw = _offset_weight_grad(_round(x, torch.bfloat16), dyg, parent_off,
                                 w.shape[0])
        return dx, dw.to(w.dtype), None, None, None, None, None


class _SparseConvTransposeGF(torch.autograd.Function):
    """Stride-2 transpose (up) conv with a gather-only backward through
    the dual child map: dx[c] = sum_k dy[child[c, k]] @ W[k]^T."""

    @staticmethod
    def forward(ctx, x, w, parent, parent_off, child, out_valid, in_valid):
        ctx.save_for_backward(x, w, parent, parent_off, child, out_valid,
                              in_valid)
        return sparse_conv_transpose(x, parent, parent_off, w, out_valid)

    @staticmethod
    def backward(ctx, dy):
        x, w, parent, parent_off, child, out_valid, in_valid = \
            ctx.saved_tensors
        dy = _mask_rows(dy, out_valid)
        dx = sparse_conv(dy, child, w.transpose(1, 2), None,
                         in_valid).to(x.dtype)
        xg = _masked_gather(_round(x, torch.bfloat16), parent)
        dw = _offset_weight_grad(xg, _round(dy, torch.bfloat16), parent_off,
                                 w.shape[0])
        return dx, dw.to(w.dtype), None, None, None, None, None


def sparse_conv_sym(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                    out_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`sparse_conv` on a symmetric stride-1 map, with the
    scatter-free backward."""
    return _SparseConvSym.apply(x, w, nbr, out_valid)


def sparse_conv_down(x: torch.Tensor, child: torch.Tensor, w: torch.Tensor,
                     parent: torch.Tensor, parent_off: torch.Tensor,
                     out_valid: Optional[torch.Tensor] = None,
                     in_valid: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Stride-2 down conv (:func:`sparse_conv` on the (N_coarse, 8) child
    map) with the scatter-free backward."""
    return _SparseConvDown.apply(x, w, child, parent, parent_off, out_valid,
                                 in_valid)


def sparse_conv_transpose_gf(x: torch.Tensor, parent: torch.Tensor,
                             parent_off: torch.Tensor, w: torch.Tensor,
                             child: torch.Tensor,
                             out_valid: Optional[torch.Tensor] = None,
                             in_valid: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """:func:`sparse_conv_transpose` with the gather-only backward."""
    return _SparseConvTransposeGF.apply(x, w, parent, parent_off, child,
                                        out_valid, in_valid)
