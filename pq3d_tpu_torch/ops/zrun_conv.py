"""Stride-1 3^3 sparse conv over the z-run plan: plan, routing, plain
version, and the wrapper of the hand-written CUDA kernel.

Counterpart of ``pq3d_tpu/ops/pallas_zt.py`` (the Pallas kernel
``pallas_zt_conv``).  Voxel rows are ravel-sorted with z fastest, so for
each output row and each of the 9 (dy, dx) kernel columns the up-to-3
z-neighbours sit in consecutive rows; the plan stores each column's first
row (``zbase``) and which kernel z-offset each of the 3 fetched slots
carries (``zcode``).  The conv computed from it is the same function as
``ops/sparse.sparse_conv`` on the (N, 27) map.

The TPU kernel's windows, selection masks and exception pass worked around
Mosaic's one-vreg in-VMEM gather; an indexed read is native on Hopper, so
the port keeps only ``zbase``/``zcode``.  On a CUDA tensor
:func:`zrun_conv` launches ``csrc/zrun_conv.cu``; on a CPU tensor it runs
:func:`zrun_conv_reference`.  A failed build or launch raises: there is no
fallback to the plain version on the card.

Training goes through :func:`zrun_conv_sym`, the counterpart of
``pallas_zt_conv_sym``: the 3^3 stencil is symmetric, so ``dx`` is the
same kernel applied to the masked ``dy`` with ``flip_k(W)^T``, and ``dW``
re-gathers ``x`` through the same plan (:func:`zrun_weight_grad`, plain
PyTorch, as the JAX package computes it in XLA) instead of storing the
27 x N x Cin gathered taps.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional, Tuple

import torch

from pq3d_tpu_torch._build import CSRC_DIR, build_shared
from pq3d_tpu_torch.ops import sparse

# routing threshold: the smallest row count the routed convs run at (the
# JAX package's pallas_zt_applicable uses the same bound).  Tests lower it.
MIN_ROWS = 40960

# launches of the CUDA kernel since the last reset (a plain counter that
# smoke runs set to 0 before the main path and read after it), and the
# same launches split by the pass that made them: "fwd" (the conv) and
# "bwd" (its dx)
launches = 0
phase_launches = {"fwd": 0, "bwd": 0}

_SRC = os.path.join(CSRC_DIR, "zrun_conv.cu")
_NVCC_FLAGS = ["-O3", "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]
_LOCK = threading.Lock()
_LIB = None


def applicable(n_rows: int, cin: int, cout: int) -> bool:
    """Route a stride-1 3^3 conv of this shape to the kernel?

    The JAX package's ``pallas_zt_applicable`` without its backend test:
    96 <= max(Cin, Cout) < 256, not claimed by the z-run gather predicate,
    N a multiple of 128 and N >= ``MIN_ROWS``."""
    c = max(cin, cout)
    if not (96 <= c < 256):
        return False
    if sparse.ztriple_applicable(n_rows, cin, cout):
        return False
    return n_rows % 128 == 0 and n_rows >= MIN_ROWS


def zrun_plan(nbr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 27) neighbor map -> ``zbase`` (N, 9) int32, ``zcode`` (N, 9, 3)
    int8 (the JAX package's ``device_zrun_plan``; bit-identical to
    ``kernel_maps.build_ztriple_plan``).

    ``zbase[o, c]`` is the first existing neighbour row of output o's
    column c, clamped to N-3 so a 3-row fetch stays in bounds (0 when the
    column has no neighbour); ``zcode[o, c, p]`` is the kernel z-offset
    (-1/0/+1) at row ``zbase + p``, or -2.  Tap order is z-fastest
    (kernel_maps.kernel_offsets), i.e. tap = 3*c + dz + 1.
    """
    n = nbr.shape[0]
    big = 1 << 24
    nbrr = nbr.reshape(n, 9, 3).int()
    zbase = torch.where(nbrr >= 0, nbrr, big).amin(2)
    has = zbase != big
    zbase = torch.where(has, zbase.clamp_max(n - 3), 0).int()
    zcode = torch.full((n, 9, 3), -2, dtype=torch.int8, device=nbr.device)
    for p in range(3):
        for d in range(3):
            m = has & (nbrr[:, :, d] == zbase + p)
            zcode[:, :, p] = torch.where(
                m, torch.tensor(d - 1, dtype=torch.int8, device=nbr.device),
                zcode[:, :, p])
    return zbase, zcode


def _tap_rows(xb: torch.Tensor, zbase: torch.Tensor, zcode: torch.Tensor):
    """Yield (tap, rows): for each of the 27 taps (z-fastest order,
    tap = 3*c + dz + 1) the (N, Cin) rows of ``xb`` it reads, zero where
    the tap has no neighbour.  Per column the 3 consecutive rows from
    ``zbase`` are gathered once; ``zcode`` picks the row carrying each
    z-offset (each offset sits in at most one slot)."""
    for c in range(9):
        base = zbase[:, c].long()
        trips = [xb.index_select(0, base + p) for p in range(3)]
        for dz in (-1, 0, 1):
            xi = torch.zeros_like(trips[0])
            for p in range(3):
                m = (zcode[:, c, p] == dz)[:, None]
                xi = xi + torch.where(m, trips[p], 0)
            yield c * 3 + dz + 1, xi


def zrun_conv_reference(x: torch.Tensor, w: torch.Tensor,
                        zbase: torch.Tensor, zcode: torch.Tensor,
                        out_valid: Optional[torch.Tensor] = None,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the JAX package's
    ``sparse_conv_ztriple``): the 27 taps' rows (:func:`_tap_rows`) times
    W, operands rounded to ``compute_dtype``, f32 accumulation.  Returns
    (N, Cout) in x.dtype."""
    xb = sparse._round(x, compute_dtype)
    wb = sparse._round(w, compute_dtype)
    acc = torch.zeros(zbase.shape[0], w.shape[2], dtype=torch.float32,
                      device=x.device)
    for tap, xi in _tap_rows(xb, zbase, zcode):
        acc.addmm_(xi, wb[tap])
    if out_valid is not None:
        acc = torch.where(out_valid[:, None], acc, 0)
    return acc.to(x.dtype)


def zrun_weight_grad(x: torch.Tensor, zbase: torch.Tensor,
                     zcode: torch.Tensor, dy: torch.Tensor,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """dW (27, Cin, Cout) f32 of the z-run conv: ``dW[tap] = rows(x)^T @
    dy`` with x and dy rounded to ``compute_dtype`` and f32 accumulation
    (the JAX package's ``_ztriple_weight_grad``).  Re-gathers x through the
    plan instead of storing the 27 gathered taps."""
    xb = sparse._round(x, compute_dtype)
    dyb = sparse._round(dy, compute_dtype)
    return torch.stack([xi.t() @ dyb
                        for _, xi in _tap_rows(xb, zbase, zcode)])


def zrun_conv_backward_reference(x: torch.Tensor, w: torch.Tensor,
                                 zbase: torch.Tensor, zcode: torch.Tensor,
                                 out_valid: Optional[torch.Tensor],
                                 dy: torch.Tensor):
    """Plain twin of :func:`zrun_conv_sym`'s backward: (dx, dW) with the
    plain forward applied to the masked ``dy`` and ``flip_k(W)^T``."""
    if out_valid is not None:
        dy = torch.where(out_valid[:, None], dy, 0)
    dx = zrun_conv_reference(dy, w.flip(0).transpose(1, 2), zbase, zcode)
    return dx.to(x.dtype), zrun_weight_grad(x, zbase, zcode, dy).to(w.dtype)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the zrun conv kernel is built from "
                       "csrc/zrun_conv.cu at first use and needs the CUDA "
                       "toolkit")


def build() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            so = build_shared(_SRC, "torch_ext", [_nvcc()], _NVCC_FLAGS)
            lib = ctypes.CDLL(so)
            lib.pq3d_zrun_conv.argtypes = (
                [ctypes.c_void_p] * 6
                + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p])
            lib.pq3d_zrun_conv.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def zrun_conv(x: torch.Tensor, w: torch.Tensor, zbase: torch.Tensor,
              zcode: torch.Tensor,
              out_valid: Optional[torch.Tensor] = None,
              phase: str = "fwd") -> torch.Tensor:
    """y (N, Cout) = the stride-1 3^3 conv of x (N, Cin) with w (27, Cin,
    Cout) over the z-run plan; operands rounded to bf16, f32 accumulation,
    output in x.dtype, rows with ``out_valid`` False zeroed.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    and counts it under ``phase`` ("fwd" or "bwd").  Not differentiable
    itself: training goes through :func:`zrun_conv_sym`."""
    if x.device.type == "cpu":
        return zrun_conv_reference(x, w, zbase, zcode, out_valid)
    if x.device.type != "cuda":
        raise ValueError(f"zrun_conv: unsupported device {x.device}")
    n, cin = x.shape
    k, wcin, cout = w.shape
    if k != 27 or wcin != cin:
        raise ValueError(f"zrun_conv: w {tuple(w.shape)} does not match "
                         f"x {tuple(x.shape)}")
    if cin % 16 or cout % 16 or cout > 240:
        raise ValueError(f"zrun_conv: needs Cin, Cout multiples of 16 and "
                         f"Cout <= 240 (got {cin}, {cout})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"zrun_conv: x must be f32 or bf16, got {x.dtype}")
    if (zbase.shape != (n, 9) or zbase.dtype != torch.int32
            or zcode.shape != (n, 9, 3) or zcode.dtype != torch.int8):
        raise ValueError("zrun_conv: zbase must be (N, 9) int32 and zcode "
                         "(N, 9, 3) int8")
    if out_valid is not None and (out_valid.shape != (n,)
                                  or out_valid.dtype != torch.bool):
        raise ValueError("zrun_conv: out_valid must be (N,) bool")
    tensors = [x, zbase, zcode] + ([out_valid] if out_valid is not None
                                   else [])
    if any(t.device != x.device for t in tensors + [w]):
        raise ValueError("zrun_conv: all inputs must be on one device")
    x = x.contiguous()
    zbase = zbase.contiguous()
    zcode = zcode.contiguous()
    wb = w.to(torch.bfloat16).contiguous()
    if x.data_ptr() % 16 or wb.data_ptr() % 32:
        raise ValueError("zrun_conv: x must be 16-byte aligned (vector "
                         "loads) and w 32-byte aligned (WMMA loads)")
    y = torch.empty(n, cout, dtype=x.dtype, device=x.device)
    lib = build()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.pq3d_zrun_conv(
        x.data_ptr(), wb.data_ptr(), zbase.data_ptr(), zcode.data_ptr(),
        out_valid.contiguous().data_ptr() if out_valid is not None else None,
        y.data_ptr(), n, cin, cout, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"zrun_conv kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    phase_launches[phase] += 1
    return y


def reset_counts() -> None:
    """Set every launch count to 0."""
    global launches
    launches = 0
    for k in phase_launches:
        phase_launches[k] = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if contiguous and 16-byte aligned, else a fresh
    contiguous copy (a gradient from autograd may be a strided view or
    start at an offset, e.g. one half of a ``torch.cat``'s gradient)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


class _ZrunConvSym(torch.autograd.Function):
    """The z-run conv with the scatter-free symmetric-stencil backward;
    saves only its input, W and the plan."""

    @staticmethod
    def forward(ctx, x, w, zbase, zcode, out_valid):
        ctx.save_for_backward(x, w, zbase, zcode, out_valid)
        return zrun_conv(x, w, zbase, zcode, out_valid)

    @staticmethod
    def backward(ctx, dy):
        x, w, zbase, zcode, out_valid = ctx.saved_tensors
        if out_valid is not None:
            dy = torch.where(out_valid[:, None], dy, 0)
        dy = _aligned(dy)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = zrun_conv(dy, w.flip(0).transpose(1, 2), zbase, zcode,
                           phase="bwd").to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = zrun_weight_grad(x, zbase, zcode, dy).to(w.dtype)
        return dx, dw, None, None, None


def zrun_conv_sym(x: torch.Tensor, w: torch.Tensor, zbase: torch.Tensor,
                  zcode: torch.Tensor,
                  out_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`zrun_conv` with a backward: dx launches the same kernel on
    the masked dy with ``flip_k(W)^T`` (the plain version on the CPU), dW
    is :func:`zrun_weight_grad`."""
    return _ZrunConvSym.apply(x, w, zbase, zcode, out_valid)
