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

The conv options of the JAX package, computed there in XLA and here in
plain PyTorch: ``sorted_maps`` (each tap's indices made monotone by a
running max, :func:`sorted_conv_maps`; the same values), ``int8_gather``
(:func:`quantize_rows`: the gathered rows are int8, the scale folded into
W, or for the transpose conv into the gathered products) and the
tap-compacted conv (:func:`sparse_conv_compact` over a
``ops/kernel_maps.build_compact_conv`` plan).  Under ``grad_mode
'native'`` the model differentiates these functions by autograd: the
gathers' backward is ``index_select``'s scatter-add (atomic adds on the
card, so not bit-reproducible there).

Training uses the scatter-free convs of the JAX package (its custom VJPs):
every map has an exact transpose map, so ``dx`` is another gather-GEMM
conv and ``dW`` re-gathers the input.  Each is an ``autograd.Function``
that saves only its input, W and the maps, never the K x N x Cin gathered
taps that plain autograd through :func:`sparse_conv` would keep.  Like
the JAX VJPs they round ``x`` and ``dy`` to ``compute_dtype`` and
accumulate ``dW`` in f32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def _round(t: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Round to ``compute_dtype`` and return f32 (exact for bf16/f16/f32)."""
    return t.to(compute_dtype).float()


def fast_row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of (N, C) ``x`` at in-bounds indices ``idx``."""
    return x.index_select(0, idx)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if contiguous and 16-byte aligned, else a fresh
    contiguous copy, for the CUDA kernels' 16-byte row loads (a gradient
    from autograd may be a strided view or start at an offset, e.g. one
    half of a ``torch.cat``'s gradient)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _masked_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows at ``idx``; rows where ``idx < 0`` are zero."""
    rows = x.index_select(0, idx.clamp_min(0))
    return torch.where((idx >= 0)[:, None], rows, 0)


def sorted_conv_maps(nbr: torch.Tensor):
    """(N, K) neighbor map -> (idx, valid) with each tap's indices
    monotone down the rows: a missing row (-1) takes the previous valid
    index (a running max, the JAX package's ``sorted_conv_maps``), so a
    gather at ``idx`` masked by ``valid`` reads the same rows as the
    default map."""
    valid = nbr >= 0
    idx = torch.where(valid, nbr, -1).cummax(0).values
    return idx.clamp_min(0), valid


def quantize_rows(x: torch.Tensor, eps: float = 1e-6):
    """Per-channel symmetric int8 quantization of an (N, C) activation (the
    JAX package's ``quantize_rows``): ``s = max(max|x|, eps) / 127`` per
    channel and ``q = clip(round(x / s), -127, 127)`` as int8, rounding
    half to even as ``jnp.round`` does.  Returns ``(q, s)``, ``x ~= q * s``.
    """
    xf = x.float()
    s = xf.abs().amax(0).clamp_min(eps) / 127.0
    q = torch.round(xf / s).clamp(-127, 127).to(torch.int8)
    return q, s


def _sorted_idx(nbr: torch.Tensor, sorted_maps):
    """The monotone map of ``nbr`` for a conv's ``sorted_maps`` argument:
    None (off), computed here (True), or given: a forward computes each
    map's :func:`sorted_conv_maps` once for all its convs, as XLA's common
    subexpression elimination does the JAX package's per-conv calls."""
    if isinstance(sorted_maps, tuple):
        return sorted_maps
    return sorted_conv_maps(nbr) if sorted_maps else None


def _tap_gather(xb: torch.Tensor, nbr: torch.Tensor, k: int, sorted_idx
                ) -> torch.Tensor:
    """Tap ``k``'s rows of ``xb`` (zero where the map has no neighbour),
    through the monotone map ``sorted_idx`` = (idx, valid) when given."""
    if sorted_idx is None:
        return _masked_gather(xb, nbr[:, k])
    idx, valid = sorted_idx
    return torch.where(valid[:, k, None], xb.index_select(0, idx[:, k]), 0)


def _operands(x: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype,
              int8_gather: bool):
    """The gather source and the weights of a conv: ``x`` and ``w`` rounded
    to ``compute_dtype``, or with ``int8_gather`` the int8 rows of
    :func:`quantize_rows` (cast after the gather) and ``w`` with the
    scale folded in f32, then rounded."""
    if int8_gather:
        q, scale = quantize_rows(x)
        return q, _round(w.float() * scale[None, :, None], compute_dtype)
    return _round(x, compute_dtype), _round(w, compute_dtype)


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


def _column_rows(xb: torch.Tensor, zbase: torch.Tensor, zcode: torch.Tensor):
    """Yield (c, rows) through a z-run plan: for each of the 9 (dy, dx)
    kernel columns the (N, 3, Cin) rows its taps 3c + k (k = dz + 1, the
    z-fastest tap order) read, zero where a tap has no neighbour.  As in
    the JAX package, ``x3[i] = [x[i-1], x[i], x[i+1]]`` is built once and
    each column's 3 consecutive rows from ``zbase`` come in one
    (3*Cin)-wide gather at ``zbase + 1``; ``zcode`` names the fetched slot
    of each z-offset (at most one), which a second gather moves into
    place: no arithmetic, so the rows are exact."""
    n, cin = xb.shape
    x3 = torch.cat([xb.roll(1, 0), xb, xb.roll(-1, 0)], 1)
    dzs = torch.arange(-1, 2, dtype=zcode.dtype, device=zcode.device)
    for c in range(9):
        idx = (zbase[:, c].long() + 1).clamp_max(n - 1)
        trip = x3.index_select(0, idx).view(-1, 3, cin)
        hit = zcode[:, c, :, None] == dzs         # (N, slot, dz)
        slot = hit.int().argmax(1)                # (N, dz)
        rows = trip.gather(1, slot[:, :, None].expand(-1, -1, cin))
        yield c, torch.where(hit.any(1)[:, :, None], rows, 0)


def sparse_conv_ztriple(x: torch.Tensor, zbase: torch.Tensor,
                        zcode: torch.Tensor, w: torch.Tensor,
                        out_valid: Optional[torch.Tensor] = None,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """Stride-1 3^3 sparse conv through the z-run plan: 9 wide gathers
    instead of 27 (the JAX package's ``sparse_conv_ztriple``, computed
    there in XLA, so here in plain PyTorch).  Operands rounded to
    ``compute_dtype``, f32 accumulation; the same function as
    :func:`sparse_conv` on the (N, 27) map the plan was built from.

    Args:
      x:     (N, Cin) voxel features (padded rows zero).
      zbase: (N, 9) int32 run bases (ops/kernel_maps.build_ztriple_plan or
             ops/zrun_conv.zrun_plan).
      zcode: (N, 9, 3) int8 kernel z-offset per fetched slot, -2 = none.
      w:     (27, Cin, Cout), taps z-fastest (kernel_offsets).
    Returns: (N, Cout) in x.dtype.
    """
    xb = _round(x, compute_dtype)
    wb = _round(w, compute_dtype)
    acc = torch.zeros(zbase.shape[0], w.shape[2], dtype=torch.float32,
                      device=x.device)
    for c, rows in _column_rows(xb, zbase, zcode):
        for k in range(3):             # the taps in order, as JAX sums them
            acc.addmm_(rows[:, k], wb[3 * c + k])
    if out_valid is not None:
        acc = torch.where(out_valid[:, None], acc, 0)
    return acc.to(x.dtype)


def ztriple_weight_grad(x: torch.Tensor, zbase: torch.Tensor,
                        zcode: torch.Tensor, dy: torch.Tensor,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """dW (27, Cin, Cout) f32 of the z-run conv: ``dW[tap] = rows(x)^T @
    dy`` with x and dy rounded to ``compute_dtype`` and f32 accumulation
    (the JAX package's ``_ztriple_weight_grad``).  Re-gathers x through
    the plan instead of storing the 27 gathered taps; the z-run gather
    conv and kernel B1 (ops/zrun_conv) both take their dW from here."""
    xb = _round(x, compute_dtype)
    dyb = _round(dy, compute_dtype)
    return torch.stack([rows[:, k].t() @ dyb
                        for _, rows in _column_rows(xb, zbase, zcode)
                        for k in range(3)])


def sparse_conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_valid: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                sorted_maps=False,
                int8_gather: bool = False) -> torch.Tensor:
    """Sparse convolution via gather -> GEMM (plain PyTorch).

    Args:
      x:    (N_in, Cin) voxel features (padded rows zero).
      nbr:  (N_out, K) int neighbor map, -1 for missing.
      w:    (K, Cin, Cout) kernel weights.
      bias: optional (Cout,).
      out_valid: optional (N_out,) bool mask; invalid rows are zeroed.
      sorted_maps: gather through :func:`sorted_conv_maps` (same values):
        True, or the map's monotone (idx, valid) computed beforehand.
      int8_gather: gather int8 rows of :func:`quantize_rows` and fold the
        per-channel scale into ``w`` (in f32, then rounded).
    Returns: (N_out, Cout) in x.dtype.  The forward of the JAX package's
    ``sparse_conv_sym`` and ``sparse_conv_down`` is this function.
    """
    xb, wb = _operands(x, w, compute_dtype, int8_gather)
    sidx = _sorted_idx(nbr, sorted_maps)
    acc = torch.zeros(nbr.shape[0], w.shape[-1], dtype=torch.float32,
                      device=x.device)
    for k in range(nbr.shape[1]):
        # int8 rows become f32 exactly (f32 rows: no copy)
        acc.addmm_(_tap_gather(xb, nbr, k, sidx).float(), wb[k])
    if bias is not None:
        acc = acc + bias
    if out_valid is not None:
        acc = torch.where(out_valid[:, None], acc, 0)
    return acc.to(x.dtype)


def sparse_conv_transpose(x: torch.Tensor, parent: torch.Tensor,
                          parent_off: torch.Tensor, w: torch.Tensor,
                          out_valid: Optional[torch.Tensor] = None,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          int8_gather: bool = False) -> torch.Tensor:
    """Stride-2 transposed (upsampling) convolution, kernel 2^3.

    Each fine voxel has one coarse parent and a kernel offset id, so the
    8 GEMMs run on the coarse level and one gather picks each fine row.

    Args:
      x:          (N_coarse, Cin) coarse features.
      parent:     (N_fine,) int parent index, -1 for pads.
      parent_off: (N_fine,) int kernel offset id in [0, 8).
      w:          (8, Cin, Cout).
      int8_gather: quantize the 8 * N_coarse partial products per channel
        (:func:`quantize_rows`), gather the int8 rows and dequantize them
        as ``compute_dtype(q) * scale``.
    Returns: (N_fine, Cout) in x.dtype.
    """
    n_coarse = x.shape[0]
    y = torch.einsum("nc,kcd->knd", _round(x, compute_dtype),
                     _round(w, compute_dtype))        # (8, Nc, Cout) f32
    y = y.reshape(8 * n_coarse, -1)
    flat = parent_off.long() * n_coarse + parent.clamp_min(0).long()
    if int8_gather:
        q, scale = quantize_rows(y)
        out = _round(fast_row_gather(q, flat), compute_dtype) * scale
    else:
        out = fast_row_gather(y, flat)
    out = torch.where((parent >= 0)[:, None], out, 0)
    if out_valid is not None:
        out = torch.where(out_valid[:, None], out, 0)
    return out.to(x.dtype)


def pool_transpose(x_coarse: torch.Tensor, ancestor: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Broadcast coarse features to fine voxels by ancestor index
    (MinkowskiPoolingTranspose chained to level 0): each fine row takes the
    row of its ancestor; rows with ``valid`` False are zero."""
    out = fast_row_gather(x_coarse, ancestor.long().clamp_min(0))
    if valid is not None:
        out = torch.where(valid[:, None], out, 0)
    return out


def avg_pool_stride2(x: torch.Tensor, child: torch.Tensor) -> torch.Tensor:
    """Average-pool fine features into coarse voxels through the (Nc, K)
    child map (-1 = no child); a coarse row without children is 0."""
    m = child >= 0
    n_coarse, k = child.shape
    xi = fast_row_gather(x, child.long().clamp_min(0).reshape(-1))
    xi = torch.where(m[..., None], xi.reshape(n_coarse, k, -1), 0)
    cnt = m.sum(1, keepdim=True).clamp_min(1)
    return xi.sum(1) / cnt


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
        # conv3d's function with cuDNN's TF32 off as an argument of the
        # call: an exported graph keeps the arguments, while a flags
        # context would be lost and the card would run TF32
        y = torch._convolution(halo.permute(0, 4, 1, 2, 3), w5, None,
                               [1] * 3, [0] * 3, [1] * 3, False, [0] * 3, 1,
                               False, False, True, False)  # (NB, Cout, b^3)
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
    blocks and a dense 3D conv (``torch._convolution``, without TF32) runs
    the 5^3 conv (both are cross-correlation, so the weights only change
    layout).  The output is rounded to
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
                     compute_dtype: torch.dtype = torch.bfloat16,
                     sorted_maps=False) -> torch.Tensor:
    """dW[k] = gather(x, nbr[:, k])^T @ dy, one GEMM per tap on operands
    rounded to ``compute_dtype``, f32 accumulation (re-gathers instead of
    using stored activations)."""
    xb = _round(x, compute_dtype)
    dyb = _round(dy, compute_dtype)
    sidx = _sorted_idx(nbr, sorted_maps)
    return torch.stack([_tap_gather(xb, nbr, k, sidx).t() @ dyb
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
    def forward(ctx, x, w, nbr, out_valid, sorted_maps):
        ctx.save_for_backward(x, w, nbr, out_valid)
        ctx.sorted_maps = sorted_maps
        return sparse_conv(x, nbr, w, None, out_valid,
                           sorted_maps=sorted_maps)

    @staticmethod
    def backward(ctx, dy):
        x, w, nbr, out_valid = ctx.saved_tensors
        sm = ctx.sorted_maps
        dy = _mask_rows(dy, out_valid)
        dx = None
        if ctx.needs_input_grad[0]:      # not for the stem: x is data
            dx = sparse_conv(dy, nbr, w.flip(0).transpose(1, 2),
                             sorted_maps=sm).to(x.dtype)
        dw = conv_weight_grad(x, nbr, dy, sorted_maps=sm).to(w.dtype)
        return dx, dw, None, None, None


class _SparseConvDown(torch.autograd.Function):
    """Stride-2 down conv over the child map; the transpose runs through
    the dual parent/parent_off maps."""

    @staticmethod
    def forward(ctx, x, w, child, parent, parent_off, out_valid, in_valid,
                sorted_maps):
        ctx.save_for_backward(x, w, parent, parent_off, out_valid, in_valid)
        return sparse_conv(x, child, w, None, out_valid,
                           sorted_maps=sorted_maps)

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
        return dx, dw.to(w.dtype), None, None, None, None, None, None


class _SparseConvTransposeGF(torch.autograd.Function):
    """Stride-2 transpose (up) conv with a gather-only backward through
    the dual child map: dx[c] = sum_k dy[child[c, k]] @ W[k]^T."""

    @staticmethod
    def forward(ctx, x, w, parent, parent_off, child, out_valid, in_valid,
                sorted_maps):
        ctx.save_for_backward(x, w, parent, parent_off, child, out_valid,
                              in_valid)
        ctx.sorted_maps = sorted_maps
        return sparse_conv_transpose(x, parent, parent_off, w, out_valid)

    @staticmethod
    def backward(ctx, dy):
        x, w, parent, parent_off, child, out_valid, in_valid = \
            ctx.saved_tensors
        dy = _mask_rows(dy, out_valid)
        dx = sparse_conv(dy, child, w.transpose(1, 2), None, in_valid,
                         sorted_maps=ctx.sorted_maps).to(x.dtype)
        xg = _masked_gather(_round(x, torch.bfloat16), parent)
        dw = _offset_weight_grad(xg, _round(dy, torch.bfloat16), parent_off,
                                 w.shape[0])
        return dx, dw.to(w.dtype), None, None, None, None, None, None


class _SparseConvZtripleSym(torch.autograd.Function):
    """The z-run gather conv with the symmetric-stencil backward: the z-run
    conv computes conv(., nbr, .) for any weights, so dx runs through the
    same plan with ``flip_k(W)^T``; dW re-gathers x through it."""

    @staticmethod
    def forward(ctx, x, w, zbase, zcode, out_valid):
        ctx.save_for_backward(x, w, zbase, zcode, out_valid)
        return sparse_conv_ztriple(x, zbase, zcode, w, out_valid)

    @staticmethod
    def backward(ctx, dy):
        x, w, zbase, zcode, out_valid = ctx.saved_tensors
        dy = _mask_rows(dy, out_valid)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = sparse_conv_ztriple(dy, zbase, zcode,
                                     w.flip(0).transpose(1, 2)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = ztriple_weight_grad(x, zbase, zcode, dy).to(w.dtype)
        return dx, dw, None, None, None


def sparse_conv_ztriple_sym(x: torch.Tensor, zbase: torch.Tensor,
                            zcode: torch.Tensor, w: torch.Tensor,
                            out_valid: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """:func:`sparse_conv_ztriple` with the scatter-free backward (the JAX
    package's ``sparse_conv_ztriple_sym``); saves only x, W and the
    plan."""
    return _SparseConvZtripleSym.apply(x, w, zbase, zcode, out_valid)


def sparse_conv_sym(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                    out_valid: Optional[torch.Tensor] = None,
                    sorted_maps=False) -> torch.Tensor:
    """:func:`sparse_conv` on a symmetric stride-1 map, with the
    scatter-free backward."""
    return _SparseConvSym.apply(x, w, nbr, out_valid, sorted_maps)


def sparse_conv_down(x: torch.Tensor, child: torch.Tensor, w: torch.Tensor,
                     parent: torch.Tensor, parent_off: torch.Tensor,
                     out_valid: Optional[torch.Tensor] = None,
                     in_valid: Optional[torch.Tensor] = None,
                     sorted_maps=False) -> torch.Tensor:
    """Stride-2 down conv (:func:`sparse_conv` on the (N_coarse, 8) child
    map) with the scatter-free backward."""
    return _SparseConvDown.apply(x, w, child, parent, parent_off, out_valid,
                                 in_valid, sorted_maps)


def sparse_conv_transpose_gf(x: torch.Tensor, parent: torch.Tensor,
                             parent_off: torch.Tensor, w: torch.Tensor,
                             child: torch.Tensor,
                             out_valid: Optional[torch.Tensor] = None,
                             in_valid: Optional[torch.Tensor] = None,
                             sorted_maps=False) -> torch.Tensor:
    """:func:`sparse_conv_transpose` with the gather-only backward (its dx
    runs :func:`sparse_conv` on the child map, through
    :func:`sorted_conv_maps` with ``sorted_maps``)."""
    return _SparseConvTransposeGF.apply(x, w, parent, parent_off, child,
                                        out_valid, in_valid, sorted_maps)


# a compact plan's arrays, in the order _SparseConvCompactSym takes them
PLAN_KEYS = ("in_idx", "out_idx", "slots_a", "slots_b", "src")


def sparse_conv_compact(x: torch.Tensor, plan: Dict[str, torch.Tensor],
                        w: torch.Tensor,
                        out_valid: Optional[torch.Tensor] = None,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        int8_gather: bool = False) -> torch.Tensor:
    """Tap-compacted conv over a ``ops/kernel_maps.build_compact_conv``
    plan (the JAX package's ``sparse_conv_compact``): one GEMM per tap on
    the valid pairs' gathered rows only, each product stored in
    ``compute_dtype`` as JAX stores it (``preferred_element_type=
    compute_dtype``), then each output row sums its partial products in
    f32 by static addresses, slot by slot (light rows and heavy rows in
    two fixed-width groups), and one gather through ``src`` puts the rows
    in output order.  No scatter.  ``int8_gather`` gathers int8 rows and
    folds the scale into ``w`` as :func:`sparse_conv` does."""
    k, m = plan["in_idx"].shape
    cout = w.shape[-1]
    xb, wb = _operands(x, w, compute_dtype, int8_gather)
    z = torch.zeros(k * m + 1, cout, dtype=torch.float32, device=x.device)
    for t in range(k):
        z[t * m:(t + 1) * m] = _round(
            _masked_gather(xb, plan["in_idx"][t]).float() @ wb[t],
            compute_dtype)

    def collect(slots):
        acc = torch.zeros(slots.shape[0], cout, dtype=torch.float32,
                          device=x.device)
        for s in range(slots.shape[1]):
            a = slots[:, s]
            acc += z.index_select(0, torch.where(a >= 0, a, k * m))
        return acc

    allacc = torch.cat([collect(plan["slots_a"]), collect(plan["slots_b"]),
                        z.new_zeros(1, cout)])
    out = allacc.index_select(0, plan["src"])
    if out_valid is not None:
        out = torch.where(out_valid[:, None], out, 0)
    return out.to(x.dtype)


def compact_weight_grad(x: torch.Tensor, in_idx: torch.Tensor,
                        out_idx: torch.Tensor, dy: torch.Tensor,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """dW[k] = gather(x, in_idx[k])^T @ gather(dy, out_idx[k]) over the
    valid pairs only, on operands rounded to ``compute_dtype``, f32
    accumulation."""
    xb = _round(x, compute_dtype)
    dyb = _round(dy, compute_dtype)
    dws = []
    for t in range(in_idx.shape[0]):
        ok = (in_idx[t] >= 0)[:, None]
        xi = torch.where(ok, xb.index_select(0, in_idx[t].clamp_min(0)), 0)
        gi = torch.where(ok, dyb.index_select(0, out_idx[t].clamp_min(0)),
                         0)
        dws.append(xi.t() @ gi)
    return torch.stack(dws)


class _SparseConvCompactSym(torch.autograd.Function):
    """The compact conv with the scatter-free symmetric-stencil backward:
    the pair relation of a symmetric map is self-dual, so dx runs through
    the same plan with ``flip_k(W)^T`` and dW re-gathers the valid pairs
    (:func:`compact_weight_grad`).  Saves x, W and the plan only."""

    @staticmethod
    def forward(ctx, x, w, out_valid, *plan):
        ctx.save_for_backward(x, w, out_valid, *plan)
        return sparse_conv_compact(x, dict(zip(PLAN_KEYS, plan)), w,
                                   out_valid)

    @staticmethod
    def backward(ctx, dy):
        x, w, out_valid, *plan = ctx.saved_tensors
        dy = _mask_rows(dy, out_valid)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = sparse_conv_compact(dy, dict(zip(PLAN_KEYS, plan)),
                                     w.flip(0).transpose(1, 2)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = compact_weight_grad(x, plan[0], plan[1], dy).to(w.dtype)
        return (dx, dw, None) + (None,) * len(plan)


def sparse_conv_compact_sym(x: torch.Tensor, plan: Dict[str, torch.Tensor],
                            w: torch.Tensor,
                            out_valid: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """:func:`sparse_conv_compact` on a symmetric stride-1 map with the
    scatter-free backward (the JAX package's ``sparse_conv_compact_sym``).
    """
    return _SparseConvCompactSym.apply(x, w, out_valid,
                                       *(plan[k] for k in PLAN_KEYS))
