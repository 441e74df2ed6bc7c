"""Windowed sparse conv over Morton-ordered rows: host plan, plain versions,
and the wrapper of the hand-written CUDA kernel.

Counterpart of ``pq3d_tpu/ops/pallas_conv.py`` (the Pallas kernel
``windowed_sparse_conv`` and its host plan ``build_window_map``).  With
rows in Morton order (``kernel_maps.morton_order``), the neighbours of a
``tile``-row block of outputs lie mostly in one contiguous ``window``-row
slab of x starting at ``win_lo[t]``.  :func:`build_window_map` (JAX's plan,
bit for bit) stores each reference as a row of that slab (``nbr_local``,
-1 where the reference is missing or outside the window) and lists the
out-of-window references (exceptions) by tap and by tile, for an
exception pass of their own (:func:`exception_contrib`; the JAX package
leaves it to XLA).  :func:`windowed_sparse_conv_reference` is the plain
version over that plan.

The port's kernel takes another plan, made from it once per map by
:func:`fold_exceptions`: each tile's distinct out-of-window source rows
become ``X`` extra rows of its slab, after the window's, so one gather
covers every reference and there is no exception pass::

    y[j] = sum_k slab_t[nbr_slab[j, k]] @ W[k],   t = j // tile,
    slab_t = x[win_lo[t] : win_lo[t] + window] ++ x[exc_src[t]]

with missing entries (-1) reading zeros.  Both plans give the function of
``ops/sparse.sparse_conv`` on the (N, K) map they were built from, for any
K, with operands rounded to bf16 and f32 sums.

The TPU kernel also rounds ``window @ W`` to bf16 before its one-hot
gather (a workaround for Mosaic's one-vreg in-VMEM gather); the port does
not, so it computes ``sparse_conv``'s function.  On a CUDA tensor
:func:`windowed_sparse_conv` launches ``csrc/windowed_conv.cu``; on a CPU
tensor it runs :func:`windowed_sparse_conv_folded_reference`.  A failed
build or launch, or a plan whose slab does not fit shared memory, raises:
there is no fallback to the plain version on the card.  The wrapper calls
the kernel directly and is no ``torch.library`` operator (kernel B1 is
one): no model path calls it, so no exported forward (``export.py``)
reaches it.
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
build_log = ""       # the compiler's output of the loaded library's build

# what the kernel takes: a tile of at most 256 rows (16 rows a warp), a
# Cout slice of at most 128 columns a block, and its slab and W stages
# within the 227 KB of shared memory a block may use (:func:`smem_fit`)
MAX_TILE = 256
MAX_SLICE = 128
SMEM_LIMIT = 232448

# the arrays of the kernel's plan (:func:`fold_exceptions`), in the order
# :func:`windowed_sparse_conv` takes them
FOLDED_KEYS = ("win_lo", "nbr_slab", "exc_src", "tile_taps")


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


def fold_exceptions(plan: Dict[str, np.ndarray], nbr: np.ndarray,
                    tile: int = 256, window: int = 512
                    ) -> Dict[str, np.ndarray]:
    """The kernel's plan, from :func:`build_window_map`'s and the (N, K)
    map it was built from; host side, once per map.

    Each tile's distinct out-of-window source rows, in ascending order,
    become extra rows ``window ..`` of its slab.  Returns ``win_lo`` (N /
    tile,) int32 (the plan's), ``nbr_slab`` (N, K) int16 (the slab row of
    each reference: the window's row ``nbr_local`` where that is set, else
    ``window + i`` for the tile's extra row i; -1 missing), ``exc_src`` (N /
    tile, X) int32 (the extra rows' global rows, -1 padded; X the most any
    tile needs, rounded up to a multiple of 16) and ``tile_taps`` (N / tile,
    K) int16 (the taps some row of the tile references, ascending, then
    -1).  Slab rows fit 16 bits: the narrowing to int16 is exact, and
    raises where a slab would have 2^15 rows or more."""
    n, k = nbr.shape
    n_tiles = n // tile
    nbr_slab = plan["nbr_local"].astype(np.int32)
    rows, ks = np.nonzero((nbr >= 0) & (nbr_slab < 0))
    # one extra row per distinct (tile, source row)
    key = (rows // tile).astype(np.int64) * n + nbr[rows, ks]
    uniq, inv = np.unique(key, return_inverse=True)
    utile = uniq // n
    counts = np.bincount(utile, minlength=n_tiles)
    x_rows = -(-int(counts.max(initial=0)) // 16) * 16
    slot = np.arange(len(uniq)) - (np.cumsum(counts) - counts)[utile]
    exc_src = np.full((n_tiles, x_rows), -1, np.int32)
    exc_src[utile, slot] = uniq % n
    nbr_slab[rows, ks] = window + slot[inv.reshape(-1)]
    if window + x_rows >= 1 << 15:
        raise ValueError(f"fold_exceptions: a slab of {window} + {x_rows} "
                         f"rows does not fit int16 local rows")
    used = (nbr_slab.reshape(n_tiles, tile, k) >= 0).any(1)
    order = np.argsort(~used, axis=1, kind="stable")
    tile_taps = np.where(np.take_along_axis(used, order, 1), order,
                         -1).astype(np.int16)
    return {"win_lo": plan["win_lo"], "nbr_slab": nbr_slab.astype(np.int16),
            "exc_src": exc_src, "tile_taps": tile_taps}


def exception_contrib(x: torch.Tensor, w: torch.Tensor,
                      exc_in_k: torch.Tensor,
                      exc_src_tile: torch.Tensor) -> torch.Tensor:
    """(N / tile * Et, Cout) f32: the product of every out-of-window
    reference of :func:`build_window_map`'s plan, in tile order (row ``t *
    Et + slot`` belongs to tile t's exception ``slot``; padding slots carry
    some entry's product, and their ``exc_row_tile`` of -1 keeps it out of
    every output row).

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
    """Plain version over :func:`build_window_map`'s plan: each tile's
    in-window taps gathered from ``x[win_lo[t] + nbr_local]`` (-1, or a
    local row past the window, gives zeros), plus the exception rows
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


def slab_sources(win_lo: torch.Tensor, nbr_slab: torch.Tensor,
                 exc_src: torch.Tensor, tile: int = 256,
                 window: int = 512) -> torch.Tensor:
    """(N, K) int64: the global source row of every entry of
    :func:`fold_exceptions`'s plan (-1 missing, or past the tile's slab)."""
    n = nbr_slab.shape[0]
    s = nbr_slab.long()
    lo = win_lo.long().repeat_interleave(tile)[:, None]
    x_rows = exc_src.shape[1]
    if x_rows:
        t = torch.arange(n, device=s.device)[:, None] // tile
        extra = exc_src.long()[t, (s - window).clamp(0, x_rows - 1)]
    else:
        extra = torch.full_like(s, -1)
    src = torch.where(s < window, lo + s, extra)
    return torch.where((s >= 0) & (s < window + x_rows), src, -1)


def windowed_sparse_conv_folded_reference(x: torch.Tensor, w: torch.Tensor,
                                          plan: Dict, tile: int = 256,
                                          window: int = 512) -> torch.Tensor:
    """Plain version over :func:`fold_exceptions`'s plan: every tap's rows
    gathered through :func:`slab_sources`, times W.  Operands rounded to
    bf16, f32 sums.  Returns (N, Cout) f32."""
    dev = x.device
    p = {key: torch.as_tensor(plan[key], device=dev) for key in FOLDED_KEYS}
    idx = slab_sources(p["win_lo"], p["nbr_slab"], p["exc_src"], tile,
                       window)
    xb = sparse._round(x, torch.bfloat16)
    wb = sparse._round(w, torch.bfloat16)
    acc = torch.zeros(x.shape[0], w.shape[2], dtype=torch.float32,
                      device=dev)
    for k in range(w.shape[0]):
        acc.addmm_(sparse._masked_gather(xb, idx[:, k]), wb[k])
    return acc


def build() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB, build_log
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            # -Xptxas -v: registers and spills of each instantiation land
            # in the build log (chip_smoke.py prints them)
            so = build_shared(_SRC, "torch_ext", [nvcc()],
                              NVCC_FLAGS + ["-Xptxas", "-v"])
            if os.path.exists(f"{so}.log"):
                with open(f"{so}.log") as f:
                    build_log = f.read()
            lib = ctypes.CDLL(so)
            lib.pq3d_windowed_conv.argtypes = (
                [ctypes.c_void_p] * 7 + [ctypes.c_int64]
                + [ctypes.c_int] * 10 + [ctypes.c_void_p])
            lib.pq3d_windowed_conv.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def smem_fit(cin: int, cout: int, window: int, x_rows: int, k: int):
    """(ck, slab buffers, shared-memory bytes) of one block of a K-tap conv
    of Cin -> Cout: the slab (``window + x_rows`` rows and a zero row) is
    staged in chunks of ck Cin columns, the widest multiple of 16 that
    fits: one buffer when one chunk holds all of Cin (padded to 16), else
    two; its rows and the two W stages of the block's Cout slice are ck + 8
    bf16 wide; then the extra rows' sources (int32), the tile's K taps
    (int16) and two mbarriers.  Raises when nothing fits, on either
    device."""
    cin_p = -(-cin // 16) * 16
    width = _slices(cout)[0]
    for n_chunks in range(1, cin_p // 16 + 1):
        ck = -(-(-(-cin_p // n_chunks)) // 16) * 16
        bufs = 1 if ck >= cin_p else 2
        smem = (bufs * (window + x_rows + 1) + 2 * width) * (ck + 8) * 2 \
            + 4 * x_rows + 2 * k + 16
        if smem <= SMEM_LIMIT:
            return ck, bufs, smem
    raise ValueError(f"windowed_sparse_conv: a slab of {window} + {x_rows} "
                     f"rows does not fit shared memory at Cin {cin_p}, Cout "
                     f"slice {width}")


def _slices(cout: int):
    """(slice width, padded Cout): Cout split into equal slices of at most
    ``MAX_SLICE`` columns, each a multiple of 16."""
    n_slices = -(-cout // MAX_SLICE)
    width = -(-(-(-cout // n_slices)) // 16) * 16
    return width, width * n_slices


def _check(x, w, win_lo, nbr_slab, exc_src, tile_taps, tile, window):
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
    if not tile <= window <= n:
        raise ValueError(f"windowed_sparse_conv: window {window} must lie "
                         f"between tile and N={n}")
    n_tiles = n // tile
    x_rows = exc_src.shape[-1]
    want = {"win_lo": (win_lo, (n_tiles,), torch.int32),
            "nbr_slab": (nbr_slab, (n, k), torch.int16),
            "exc_src": (exc_src, (n_tiles, x_rows), torch.int32),
            "tile_taps": (tile_taps, (n_tiles, k), torch.int16)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"windowed_sparse_conv: {name} must be {shape} "
                             f"{dtype}, got {tuple(t.shape)} {t.dtype}")
    if x_rows % 16:
        raise ValueError(f"windowed_sparse_conv: exc_src's {x_rows} rows a "
                         f"tile must be a multiple of 16")
    if any(t.device != x.device for t in (w, win_lo, nbr_slab, exc_src,
                                          tile_taps)):
        raise ValueError("windowed_sparse_conv: all inputs must be on one "
                         "device")
    smem_fit(x.shape[1], w.shape[2], window, x_rows, k)


def windowed_sparse_conv(x: torch.Tensor, w: torch.Tensor,
                         win_lo: torch.Tensor, nbr_slab: torch.Tensor,
                         exc_src: torch.Tensor, tile_taps: torch.Tensor,
                         tile: int = 256, window: int = 512) -> torch.Tensor:
    """x (N, Cin), w (K, Cin, Cout) -> (N, Cout) f32 over the plan of
    :func:`fold_exceptions` (arrays as tensors on x's device, in
    ``FOLDED_KEYS`` order).

    A CPU tensor runs the plain version; a CUDA tensor runs
    :func:`prepare` and :func:`launch`."""
    _check(x, w, win_lo, nbr_slab, exc_src, tile_taps, tile, window)
    plan = dict(zip(FOLDED_KEYS, (win_lo, nbr_slab, exc_src, tile_taps)))
    if x.device.type == "cpu":
        return windowed_sparse_conv_folded_reference(x, w, plan, tile, window)
    if x.device.type != "cuda":
        raise ValueError(f"windowed_sparse_conv: unsupported device "
                         f"{x.device}")
    return launch(*prepare(x, w, exc_src.shape[1], window), *plan.values(),
                  w.shape[2], tile, window)


def prepare(x: torch.Tensor, w: torch.Tensor, x_rows: int,
            window: int = 512):
    """What the kernel reads besides the plan: x in bf16 with Cin padded
    to a multiple of 16, and W's image: each (Cout slice, Cin chunk of
    :func:`smem_fit` for a slab of ``window + x_rows`` rows, tap) as the
    rows of a W stage, (Cout_p / width, chunks, K, width, ck + 8) bf16
    with Cin contiguous and zeros in the padding, so that one bulk copy
    brings a stage."""
    cin, cout = x.shape[1], w.shape[2]
    k = w.shape[0]
    cin_p = -(-cin // 16) * 16
    width, cout_p = _slices(cout)
    ck = smem_fit(cin, cout, window, x_rows, k)[0]
    n_chunks = -(-cin_p // ck)
    xb = x.to(torch.bfloat16)
    if cin_p != cin:
        xb = F.pad(xb, (0, cin_p - cin))
    xb = sparse._aligned(xb)
    wp = F.pad(w.to(torch.bfloat16),
               (0, cout_p - cout, 0, n_chunks * ck - cin))
    img = wp.view(k, n_chunks, ck, cout_p // width, width).permute(3, 1, 0, 4,
                                                                   2)
    return xb, F.pad(img, (0, 8)).contiguous()


def launch(xb: torch.Tensor, wimg: torch.Tensor, win_lo: torch.Tensor,
           nbr_slab: torch.Tensor, exc_src: torch.Tensor,
           tile_taps: torch.Tensor, cout: int, tile: int = 256,
           window: int = 512) -> torch.Tensor:
    """Launch the kernel on :func:`prepare`'s outputs and the folded plan;
    y (N, cout) f32.  Counted in ``launches``."""
    n, cin_p = xb.shape
    k = nbr_slab.shape[1]
    width, cout_p = _slices(cout)
    x_rows = exc_src.shape[1]
    ck, bufs, _ = smem_fit(cin_p, cout, window, x_rows, k)
    plan = (win_lo, nbr_slab, exc_src, tile_taps)
    if (xb.dtype != torch.bfloat16 or wimg.dtype != torch.bfloat16
            or cin_p % 16
            or wimg.shape != (cout_p // width, -(-cin_p // ck), k, width,
                              ck + 8)
            or xb.data_ptr() % 16 or wimg.data_ptr() % 16 or n % tile
            or not all(t.is_contiguous() for t in (xb, wimg))
            or win_lo.shape != (n // tile,) or nbr_slab.shape != (n, k)
            or exc_src.shape[0] != n // tile or exc_src.shape[1] % 16
            or tile_taps.shape != (n // tile, k)
            or [t.dtype for t in plan] != [torch.int32, torch.int16,
                                           torch.int32, torch.int16]
            or any(t.device != xb.device for t in (wimg,) + plan)):
        raise ValueError("windowed_conv launch: inputs are not prepare()'s "
                         "outputs and a folded plan of this shape")
    win_lo, nbr_slab, exc_src, tile_taps = (t.contiguous() for t in plan)
    y = torch.empty(n, cout, dtype=torch.float32, device=xb.device)
    lib = build()
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    err = lib.pq3d_windowed_conv(
        xb.data_ptr(), wimg.data_ptr(), win_lo.data_ptr(), nbr_slab.data_ptr(),
        exc_src.data_ptr(), tile_taps.data_ptr(), y.data_ptr(), n, cin_p,
        cout_p, width, cout, k, tile, window, x_rows, ck, bufs, stream)
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
