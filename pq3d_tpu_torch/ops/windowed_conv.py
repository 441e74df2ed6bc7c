"""Windowed sparse conv over Morton-ordered rows: host plan, plain version,
and the wrapper of the hand-written CUDA kernel.

Counterpart of ``pq3d_tpu/ops/pallas_conv.py`` (the Pallas kernel
``windowed_sparse_conv`` and its host plan ``build_window_map``).  With
rows in Morton order (``kernel_maps.morton_order``), the neighbours of a
``tile``-row block of outputs lie mostly in one contiguous ``window``-row
slab of x starting at ``win_lo[t]``.  The plan stores each reference as a
row of that slab (``nbr_local``, -1 where the reference is missing or
outside the window) and lists the out-of-window references (exceptions)
once by tap (``exc_in_k``) and once by tile (``exc_row_tile``,
``exc_src_tile``).  The conv is the same function as
``ops/sparse.sparse_conv`` on the (N, K) map the plan was built from, for
any K::

    y[j] = sum_k x[win_lo[j // tile] + nbr_local[j, k]] @ W[k]
           + the exceptions of output row j

with operands rounded to bf16 and f32 sums.  The exceptions' products are
computed outside the kernel, as the JAX package leaves them to XLA
(:func:`exception_contrib`); the kernel adds them to its tile's rows.

The TPU kernel also rounds ``window @ W`` to bf16 before its one-hot
gather (a workaround for Mosaic's one-vreg in-VMEM gather); the port does
not, so it computes ``sparse_conv``'s function.  On a CUDA tensor
:func:`windowed_sparse_conv` launches ``csrc/windowed_conv.cu``; on a CPU
tensor it runs :func:`windowed_sparse_conv_reference`.  A failed build or
launch raises: there is no fallback to the plain version on the card.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from pq3d_tpu_torch._build import CSRC_DIR, NVCC_FLAGS, build_shared, nvcc
from pq3d_tpu_torch.ops import sparse

# launches of the CUDA kernel since the last reset (a plain counter that
# smoke runs set to 0 before a path and read after it)
launches = 0

_SRC = os.path.join(CSRC_DIR, "windowed_conv.cu")
_LOCK = threading.Lock()
_LIB = None

# what the kernel takes: a tile of at most 256 rows (16 rows a warp), a
# Cout slice of at most 128 columns a block, and two bf16 slab buffers of
# (window + 1) rows x 72 columns in the 227 KB of shared memory a block
# may use
MAX_TILE = 256
MAX_SLICE = 128
_SMEM_LIMIT = 232448
_SLAB_ROW_BYTES = (64 + 8) * 2


def build_window_map(nbr: np.ndarray, tile: int = 256, window: int = 512,
                     exc_pad_to: int = 1024) -> Dict[str, np.ndarray]:
    """Host side: per-tile window starts, local indices and the exception
    layout (a copy of the JAX package's ``build_window_map``; the same
    arrays bit for bit).

    nbr: (N, K) int32 global neighbour map (-1 missing), Morton-ordered
    rows, N a multiple of ``tile``.  Returns ``win_lo`` (N / tile,) int32
    (a multiple of 8), ``nbr_local`` (N, K) int32 (-1 = missing or not in
    the window), ``exc_in_k`` (K, E_pad) int32 (each tap's out-of-window
    source rows, -1 padded), ``exc_row_tile`` (N / tile, Et) int32 (the
    local output row of each of a tile's exceptions, -1 padded),
    ``exc_src_tile`` (N / tile, Et) int32 (its position ``k * E_pad +
    slot`` in ``exc_in_k``) and ``n_exceptions``.
    """
    n, k = nbr.shape
    assert n % tile == 0, "pad N to a multiple of tile"
    n_tiles = n // tile
    centers = np.arange(n_tiles, dtype=np.int64) * tile + tile // 2
    lo = np.clip(centers - window // 2, 0, n - window)
    lo -= lo % 8
    win_lo = np.clip(lo, 0, n - window).astype(np.int32)

    valid = nbr >= 0
    lo_rows = np.repeat(win_lo, tile)[:, None]
    local = nbr - lo_rows
    inside = valid & (local >= 0) & (local < window)
    nbr_local = np.where(inside, local, -1).astype(np.int32)

    # exceptions, grouped by tap (one batched GEMM computes them all) and
    # by tile (each tile adds its own to its output rows)
    out_rows, ks = np.nonzero(valid & ~inside)
    e = len(out_rows)
    counts = np.bincount(ks, minlength=k)
    e_max = int(counts.max()) if e else 0
    e_pad = max(exc_pad_to,
                int(np.ceil(max(e_max, 1) / exc_pad_to) * exc_pad_to))
    exc_in_k = np.full((k, e_pad), -1, np.int32)
    kpos = np.zeros(e, np.int64)          # entry -> row in (K*E_pad) layout
    if e:
        order = np.argsort(ks, kind="stable")
        slot = np.arange(e) - np.concatenate(
            [[0], np.cumsum(counts)])[ks[order]]
        exc_in_k[ks[order], slot] = nbr[out_rows[order], ks[order]]
        kpos[order] = ks[order].astype(np.int64) * e_pad + slot

    tile_id = out_rows // tile
    tcounts = np.bincount(tile_id, minlength=n_tiles)
    et_max = int(tcounts.max()) if e else 0
    et_pad = max(128, int(np.ceil(max(et_max, 1) / 128) * 128))
    exc_row_tile = np.full((n_tiles, et_pad), -1, np.int32)
    exc_src_tile = np.zeros((n_tiles, et_pad), np.int32)
    if e:
        torder = np.argsort(tile_id, kind="stable")
        tslot = np.arange(e) - np.concatenate(
            [[0], np.cumsum(tcounts)])[tile_id[torder]]
        exc_row_tile[tile_id[torder], tslot] = (out_rows % tile)[torder]
        exc_src_tile[tile_id[torder], tslot] = kpos[torder]
    return {"win_lo": win_lo, "nbr_local": nbr_local,
            "exc_in_k": exc_in_k, "exc_row_tile": exc_row_tile,
            "exc_src_tile": exc_src_tile, "n_exceptions": e}


def exception_contrib(x: torch.Tensor, w: torch.Tensor,
                      exc_in_k: torch.Tensor,
                      exc_src_tile: torch.Tensor) -> torch.Tensor:
    """(N / tile * Et, Cout) f32: the product of every out-of-window
    reference, in tile order (row ``t * Et + slot`` belongs to tile t's
    exception ``slot``; padding slots carry some entry's product, and
    their ``exc_row_tile`` of -1 keeps it out of every output row).

    One batched product over the taps (``exc_in_k``: each tap's source
    rows, -1 giving zeros), then a gather through ``exc_src_tile``.
    Operands rounded to bf16, products summed in f32 (``torch.bmm`` in
    f32; PyTorch runs f32 matrix products without TF32 unless told to)."""
    k, e_pad = exc_in_k.shape
    xi = sparse._round(sparse._masked_gather(x, exc_in_k.reshape(-1).long()),
                       torch.bfloat16).reshape(k, e_pad, x.shape[1])
    contrib = torch.bmm(xi, sparse._round(w, torch.bfloat16))
    return contrib.reshape(k * e_pad, -1).index_select(
        0, exc_src_tile.reshape(-1).long())


def windowed_sparse_conv_reference(x: torch.Tensor, w: torch.Tensor,
                                   plan: Dict, tile: int = 256,
                                   window: int = 512) -> torch.Tensor:
    """Plain PyTorch version of the kernel, from the plan alone: each
    tile's in-window taps gathered from ``x[win_lo[t] + nbr_local]`` (-1,
    or a local row past the window, gives zeros), plus the exception rows
    through ``exc_in_k``, ``exc_src_tile`` and ``exc_row_tile``.  Operands
    rounded to bf16, f32 sums.  Returns (N, Cout) f32."""
    dev = x.device
    p = {key: torch.as_tensor(v, device=dev) for key, v in plan.items()
         if key != "n_exceptions"}
    n = x.shape[0]
    nl = p["nbr_local"].long()
    lo = p["win_lo"].long().repeat_interleave(tile)[:, None]
    idx = torch.where((nl >= 0) & (nl < window), lo + nl, -1)
    xb = sparse._round(x, torch.bfloat16)
    wb = sparse._round(w, torch.bfloat16)
    acc = torch.zeros(n, w.shape[2], dtype=torch.float32, device=dev)
    for k in range(w.shape[0]):
        acc.addmm_(sparse._masked_gather(xb, idx[:, k]), wb[k])
    contrib = exception_contrib(x, w, p["exc_in_k"], p["exc_src_tile"])
    rows = p["exc_row_tile"].long()
    tile0 = torch.arange(rows.shape[0], device=dev)[:, None] * tile
    rows = torch.where(rows >= 0, rows + tile0, -1).reshape(-1)
    keep = rows >= 0
    return acc.index_add_(0, rows[keep], contrib[keep])


def build() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            so = build_shared(_SRC, "torch_ext", [nvcc()], NVCC_FLAGS)
            lib = ctypes.CDLL(so)
            lib.pq3d_windowed_conv.argtypes = (
                [ctypes.c_void_p] * 7 + [ctypes.c_int64]
                + [ctypes.c_int] * 8 + [ctypes.c_void_p])
            lib.pq3d_windowed_conv.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _slices(cout: int):
    """(slice width, padded Cout): Cout split into equal slices of at most
    ``MAX_SLICE`` columns, each a multiple of 16."""
    n_slices = -(-cout // MAX_SLICE)
    width = -(-(-(-cout // n_slices)) // 16) * 16
    return width, width * n_slices


def _check(x, w, win_lo, nbr_local, exc_in_k, exc_row_tile, exc_src_tile,
           tile, window):
    """Raise on anything the kernel does not take (on either device, so a
    CPU run refuses what the card would)."""
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"windowed_sparse_conv: w {tuple(w.shape)} does not "
                         f"match x {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"windowed_sparse_conv: x must be f32 or bf16, got "
                        f"{x.dtype}")
    n, k = x.shape[0], w.shape[0]
    if tile % 16 or not 16 <= tile <= MAX_TILE or n % tile:
        raise ValueError(f"windowed_sparse_conv: tile {tile} must be a "
                         f"multiple of 16 up to {MAX_TILE} that divides N={n}")
    if not tile <= window <= n or \
            2 * (window + 1) * _SLAB_ROW_BYTES > _SMEM_LIMIT:
        raise ValueError(f"windowed_sparse_conv: window {window} must lie "
                         f"between tile and N={n} and fit shared memory")
    n_tiles = n // tile
    want = {"win_lo": (win_lo, (n_tiles,)),
            "nbr_local": (nbr_local, (n, k)),
            "exc_in_k": (exc_in_k, (k, exc_in_k.shape[-1])),
            "exc_row_tile": (exc_row_tile, (n_tiles, exc_row_tile.shape[-1])),
            "exc_src_tile": (exc_src_tile, (n_tiles, exc_row_tile.shape[-1]))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"windowed_sparse_conv: {name} must be {shape} "
                             f"int32, got {tuple(t.shape)} {t.dtype}")
    if any(t.device != x.device for t in (w, win_lo, nbr_local, exc_in_k,
                                          exc_row_tile, exc_src_tile)):
        raise ValueError("windowed_sparse_conv: all inputs must be on one "
                         "device")


def windowed_sparse_conv(x: torch.Tensor, w: torch.Tensor,
                         win_lo: torch.Tensor, nbr_local: torch.Tensor,
                         exc_in_k: torch.Tensor, exc_row_tile: torch.Tensor,
                         exc_src_tile: torch.Tensor, tile: int = 256,
                         window: int = 512) -> torch.Tensor:
    """x (N, Cin), w (K, Cin, Cout) -> (N, Cout) f32 over the plan of
    :func:`build_window_map` (arrays as int32 tensors on x's device).

    A CPU tensor runs the plain version; a CUDA tensor runs
    :func:`prepare` and :func:`launch`."""
    _check(x, w, win_lo, nbr_local, exc_in_k, exc_row_tile, exc_src_tile,
           tile, window)
    if x.device.type == "cpu":
        plan = {"win_lo": win_lo, "nbr_local": nbr_local,
                "exc_in_k": exc_in_k, "exc_row_tile": exc_row_tile,
                "exc_src_tile": exc_src_tile}
        return windowed_sparse_conv_reference(x, w, plan, tile, window)
    if x.device.type != "cuda":
        raise ValueError(f"windowed_sparse_conv: unsupported device "
                         f"{x.device}")
    return launch(*prepare(x, w, exc_in_k, exc_src_tile), win_lo, nbr_local,
                  exc_row_tile, w.shape[2], tile, window)


def prepare(x: torch.Tensor, w: torch.Tensor, exc_in_k: torch.Tensor,
            exc_src_tile: torch.Tensor):
    """What the kernel reads besides the plan: x in bf16 with Cin padded
    to a multiple of 16, W per tap transposed to (K, Cout_p, Cin_p) bf16
    with Cout padded to whole column slices, and the exception products
    (:func:`exception_contrib`, (N / tile * Et, Cout_p) f32)."""
    cin, cout = x.shape[1], w.shape[2]
    cin_p = -(-cin // 16) * 16
    cout_p = _slices(cout)[1]
    xb = sparse._aligned(F.pad(x.to(torch.bfloat16), (0, cin_p - cin)))
    wp = F.pad(w.to(torch.bfloat16), (0, cout_p - cout, 0, cin_p - cin))
    contrib = exception_contrib(xb, wp, exc_in_k, exc_src_tile)
    return xb, wp.transpose(1, 2).contiguous(), contrib.contiguous()


def launch(xb: torch.Tensor, wt: torch.Tensor, contrib: torch.Tensor,
           win_lo: torch.Tensor, nbr_local: torch.Tensor,
           exc_row_tile: torch.Tensor, cout: int, tile: int = 256,
           window: int = 512) -> torch.Tensor:
    """Launch the kernel on :func:`prepare`'s outputs and the plan; y (N,
    cout) f32.  Counted in ``launches``."""
    n, cin_p = xb.shape
    k, cout_p, _ = wt.shape
    width = _slices(cout)[0]
    plan = (win_lo, nbr_local, exc_row_tile)
    if (xb.dtype != torch.bfloat16 or wt.dtype != torch.bfloat16
            or contrib.dtype != torch.float32 or cin_p % 16
            or wt.shape[2] != cin_p or cout_p != _slices(cout)[1]
            or contrib.shape != (exc_row_tile.numel(), cout_p)
            or xb.data_ptr() % 16 or n % tile
            or not all(t.is_contiguous() for t in (xb, wt, contrib))
            or win_lo.shape != (n // tile,) or nbr_local.shape != (n, k)
            or exc_row_tile.shape[0] != n // tile
            or any(t.dtype != torch.int32 for t in plan)
            or any(t.device != xb.device for t in (wt, contrib) + plan)):
        raise ValueError("windowed_conv launch: inputs are not prepare()'s "
                         "outputs and a plan of this shape")
    win_lo, nbr_local, exc_row_tile = (t.contiguous() for t in
                                       (win_lo, nbr_local, exc_row_tile))
    y = torch.empty(n, cout, dtype=torch.float32, device=xb.device)
    lib = build()
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    err = lib.pq3d_windowed_conv(
        xb.data_ptr(), wt.data_ptr(), win_lo.data_ptr(), nbr_local.data_ptr(),
        exc_row_tile.data_ptr(), contrib.data_ptr(), y.data_ptr(), n, cin_p,
        cout_p, width, cout, k, tile, window, exc_row_tile.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"windowed_conv kernel launch failed: cudaError "
                           f"{err}")
    global launches
    launches += 1
    return y


def reset_counts() -> None:
    """Set the launch count to 0."""
    global launches
    launches = 0
