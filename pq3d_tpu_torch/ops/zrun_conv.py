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
the port keeps only ``zbase``/``zcode``.

The kernel is the operator ``pq3d::zrun_conv`` (``torch.library``), so
``torch.export`` keeps each call as one graph node and an exported program
launches the kernel wherever it is loaded onto a card (``export.py``).
:func:`zrun_conv` checks its inputs and calls the op.  The op's CUDA
implementation launches ``csrc/zrun_conv.cu`` and counts the launch; its
CPU implementation is :func:`zrun_conv_reference`; its fake implementation
gives (N, Cout) in x.dtype.  A failed build or launch raises: there is no
fallback to the plain version on the card.  The kernel works on tiles of
``TILE`` rows and skips every (tile, tap) pair that no row of the tile
references (:func:`tile_tap_mask` computes the same pairs).

The op's backward is the counterpart of ``pallas_zt_conv_sym``'s: the 3^3
stencil is symmetric, so ``dx`` is the same kernel applied to the masked
``dy`` with ``flip_k(W)^T``, and ``dW`` re-gathers ``x`` through the same
plan (``ops/sparse.ztriple_weight_grad``, plain PyTorch, as the JAX package
computes it in XLA) instead of storing the 27 x N x Cin gathered taps.
Training calls it through :func:`zrun_conv_sym`.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import torch

from pq3d_tpu_torch._build import CSRC_DIR, NVCC_FLAGS, build_shared, nvcc
from pq3d_tpu_torch.ops import sparse

# routing threshold: the smallest row count the routed convs run at (the
# JAX package's pallas_zt_applicable uses the same bound).  Tests lower it.
MIN_ROWS = 40960

# output rows per block of the kernel; each of its two warpgroups
# multiplies MMA_ROWS of them, and skips a tap none of those rows references
TILE = 128
MMA_ROWS = 64
# the widest Cout one launch takes (a wgmma of at most 240 columns)
MAX_COLS = 240

# launches of the CUDA kernel since the last reset (a plain counter that
# smoke runs set to 0 before the main path and read after it), and the
# same launches split by the pass that made them: "fwd" (the conv) and
# "bwd" (its dx)
launches = 0
phase_launches = {"fwd": 0, "bwd": 0}

_SRC = os.path.join(CSRC_DIR, "zrun_conv.cu")
_LOCK = threading.Lock()
_LIB = None
build_log = ""       # the compiler's output of the loaded library's build
# the kernel's tile counter per (device index, stream): it is 0 between
# launches (each launch sets it back), and launches on one stream run in order
_counters = {}


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


def kernel_shape(cin: int, cout: int) -> Tuple[int, list]:
    """How the CUDA path runs a conv of this shape: (Cin padded to a
    multiple of 16, the column slices ``[(first, width), ...]`` of Cout
    padded to a multiple of 16, each at most ``MAX_COLS`` wide and a
    multiple of 16, one launch each).  Both devices call it, so a CPU run
    refuses what the card would; it takes every shape ``applicable``
    routes (96 <= max(Cin, Cout) < 256), as the JAX kernel does by padding
    both to 128 lanes."""
    if cin < 1 or cout < 1:
        raise ValueError(f"zrun_conv: needs Cin, Cout >= 1 (got {cin}, "
                         f"{cout})")
    cin_p = -(-cin // 16) * 16
    cout_p = -(-cout // 16) * 16
    n_slices = -(-cout_p // MAX_COLS)
    width = -(-cout_p // (16 * n_slices)) * 16
    return cin_p, [(c0, min(width, cout_p - c0))
                   for c0 in range(0, cout_p, width)]


def zrun_plan(nbr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., N, 27) neighbor maps -> ``zbase`` (..., N, 9) int32, ``zcode``
    (..., N, 9, 3) int8 (the JAX package's ``device_zrun_plan``, mapped
    over the leading dims; bit-identical to
    ``kernel_maps.build_ztriple_plan`` of each (N, 27) map).

    ``zbase[o, c]`` is the first existing neighbour row of output o's
    column c, clamped to N-3 so a 3-row fetch stays in bounds (0 when the
    column has no neighbour); ``zcode[o, c, p]`` is the kernel z-offset
    (-1/0/+1) at row ``zbase + p``, or -2.  Tap order is z-fastest
    (kernel_maps.kernel_offsets), i.e. tap = 3*c + dz + 1.
    """
    n = nbr.shape[-2]
    big = 1 << 24
    nbrr = nbr.reshape(nbr.shape[:-1] + (9, 3)).int()
    zbase = torch.where(nbrr >= 0, nbrr, big).amin(-1)
    has = zbase != big
    zbase = torch.where(has, zbase.clamp_max(n - 3), 0).int()
    zcode = torch.full(nbrr.shape, -2, dtype=torch.int8, device=nbr.device)
    for p in range(3):
        for d in range(3):
            m = has & (nbrr[..., d] == zbase + p)
            zcode[..., p] = torch.where(
                m, torch.tensor(d - 1, dtype=torch.int8, device=nbr.device),
                zcode[..., p])
    return zbase, zcode


def tile_tap_mask(zcode: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """(ceil(N / tile), 27) bool: the taps that any row of each run of
    ``tile`` consecutive rows references, read from ``zcode`` alone (tap =
    3*c + dz + 1).  At ``TILE`` these are the (tile, tap) pairs the
    kernel stages, at ``MMA_ROWS`` the ones its warpgroups multiply; a tile
    with no tap set is all padding and is only written."""
    n = zcode.shape[0]
    taps = torch.stack([(zcode == dz).any(2) for dz in (-1, 0, 1)],
                       2).reshape(n, 27)
    pad = -n % tile
    if pad:
        taps = torch.cat([taps, taps.new_zeros(pad, 27)])
    return taps.view(-1, tile, 27).any(1)


def zrun_conv_reference(x: torch.Tensor, w: torch.Tensor,
                        zbase: torch.Tensor, zcode: torch.Tensor,
                        out_valid: Optional[torch.Tensor] = None,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the JAX package's
    ``sparse_conv_ztriple`` (``ops/sparse.sparse_conv_ztriple``), operands
    rounded to ``compute_dtype``, f32 accumulation.  Returns (N, Cout) in
    x.dtype."""
    return sparse.sparse_conv_ztriple(x, zbase, zcode, w, out_valid,
                                      compute_dtype)


def zrun_conv_backward_reference(x: torch.Tensor, w: torch.Tensor,
                                 zbase: torch.Tensor, zcode: torch.Tensor,
                                 out_valid: Optional[torch.Tensor],
                                 dy: torch.Tensor):
    """Plain twin of :func:`zrun_conv_sym`'s backward: (dx, dW) with the
    plain forward applied to the masked ``dy`` and ``flip_k(W)^T``."""
    if out_valid is not None:
        dy = torch.where(out_valid[:, None], dy, 0)
    dx = zrun_conv_reference(dy, w.flip(0).transpose(1, 2), zbase, zcode)
    dw = sparse.ztriple_weight_grad(x, zbase, zcode, dy)
    return dx.to(x.dtype), dw.to(w.dtype)


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
            lib = ctypes.CDLL(so)
            lib.pq3d_zrun_conv.argtypes = (
                [ctypes.c_void_p] * 7
                + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p])
            lib.pq3d_zrun_conv.restype = ctypes.c_int
            if os.path.exists(f"{so}.log"):
                with open(f"{so}.log") as f:
                    build_log = f.read()
            _LIB = lib
    return _LIB


def zrun_conv(x: torch.Tensor, w: torch.Tensor, zbase: torch.Tensor,
              zcode: torch.Tensor,
              out_valid: Optional[torch.Tensor] = None,
              phase: str = "fwd") -> torch.Tensor:
    """y (N, Cout) = the stride-1 3^3 conv of x (N, Cin) with w (27, Cin,
    Cout) over the z-run plan; operands rounded to bf16, f32 accumulation,
    output in x.dtype, rows with ``out_valid`` False zeroed.

    Checks the inputs, then calls the op ``pq3d::zrun_conv``: a CPU tensor
    runs the plain version; a CUDA tensor launches the kernel (one launch
    per column slice of :func:`kernel_shape`, Cin and Cout padded with
    zeros there and the pad cut off y) and counts the call once under
    ``phase`` ("fwd" or "bwd").  Differentiable through the op's backward
    (see :func:`zrun_conv_sym`)."""
    n, cin = x.shape
    k, wcin, cout = w.shape
    if k != 27 or wcin != cin:
        raise ValueError(f"zrun_conv: w {tuple(w.shape)} does not match "
                         f"x {tuple(x.shape)}")
    kernel_shape(cin, cout)
    if phase not in phase_launches:
        raise ValueError(f"zrun_conv: unknown phase {phase!r}")
    if x.device.type == "cuda":
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"zrun_conv: x must be f32 or bf16, got "
                            f"{x.dtype}")
        if (zbase.shape != (n, 9) or zbase.dtype != torch.int32
                or zcode.shape != (n, 9, 3) or zcode.dtype != torch.int8):
            raise ValueError("zrun_conv: zbase must be (N, 9) int32 and "
                             "zcode (N, 9, 3) int8")
        if out_valid is not None and (out_valid.shape != (n,)
                                      or out_valid.dtype != torch.bool):
            raise ValueError("zrun_conv: out_valid must be (N,) bool")
        tensors = [x, w, zbase, zcode] + ([out_valid] if out_valid
                                          is not None else [])
        if any(t.device != x.device for t in tensors):
            raise ValueError("zrun_conv: all inputs must be on one device")
    elif x.device.type != "cpu":
        raise ValueError(f"zrun_conv: unsupported device {x.device}")
    return torch.ops.pq3d.zrun_conv(x, w, zbase, zcode, out_valid, phase)


# B1 as an operator of its own, so that torch.export keeps each call as one
# graph node (an exported program then launches the kernel wherever it is
# loaded onto a card) and autograd reaches the kernel's backward
@torch.library.custom_op(
    "pq3d::zrun_conv", mutates_args=(),
    schema="(Tensor x, Tensor w, Tensor zbase, Tensor zcode, "
           "Tensor? out_valid, str phase) -> Tensor")
def _zrun_conv_op(x, w, zbase, zcode, out_valid, phase):
    return zrun_conv_reference(x, w, zbase, zcode, out_valid)


@_zrun_conv_op.register_fake
def _zrun_conv_fake(x, w, zbase, zcode, out_valid, phase):
    return x.new_empty(x.shape[0], w.shape[2])


@_zrun_conv_op.register_kernel("cuda")
def _zrun_conv_launch(x, w, zbase, zcode, out_valid, phase):
    n, cin = x.shape
    cout = w.shape[2]
    cin_p, slices = kernel_shape(cin, cout)
    # the kernel gathers bf16 rows by 16-byte async copies: f32 x is cast
    # once here.  Each tap's W goes in as the image of its shared-memory
    # tile, which the kernel copies whole: (Cin/8, Cout/8) blocks of 8 x 8
    # with Cin fastest (K-major core matrices for wgmma)
    xb = x.to(torch.bfloat16)
    if cin_p != cin:
        xb = torch.nn.functional.pad(xb, (0, cin_p - cin))
    xb = xb.contiguous()
    if xb.data_ptr() % 16:
        if phase == "fwd":
            raise ValueError("zrun_conv: bf16 x must be 16-byte aligned "
                             "(the kernel's 16-byte row copies)")
        # a gradient from autograd may start at an offset (one half of a
        # torch.cat's gradient): the dx pass copies it
        xb = xb.clone()
    cout_p = slices[-1][0] + slices[-1][1]
    wb = w.to(torch.bfloat16)
    if (cin_p, cout_p) != (cin, cout):
        wb = torch.nn.functional.pad(wb, (0, cout_p - cout, 0, cin_p - cin))
    zbase = zbase.contiguous()
    zcode = zcode.contiguous()
    if out_valid is not None:
        out_valid = out_valid.contiguous()
    lib = build()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    key = (x.device.index, stream)
    counter = _counters.get(key)
    if counter is None:
        counter = _counters[key] = torch.zeros(2, dtype=torch.int32,
                                               device=x.device)
    ys = []
    for c0, width in slices:
        ws = wb if len(slices) == 1 else wb[:, :, c0:c0 + width]
        wt = (ws.reshape(27, cin_p // 8, 8, width // 8, 8)
              .permute(0, 1, 3, 4, 2).contiguous())
        ys.append(torch.empty(n, width, dtype=x.dtype, device=x.device))
        err = lib.pq3d_zrun_conv(
            xb.data_ptr(), wt.data_ptr(), zbase.data_ptr(), zcode.data_ptr(),
            out_valid.data_ptr() if out_valid is not None else None,
            ys[-1].data_ptr(), counter.data_ptr(), n, cin_p,
            width, int(x.dtype == torch.bfloat16), stream)
        if err != 0:
            raise RuntimeError(f"zrun_conv kernel launch failed: cudaError "
                               f"{err}")
    y = ys[0] if len(ys) == 1 else torch.cat(ys, 1)
    if y.shape[1] != cout:
        y = y[:, :cout].contiguous()
    global launches
    launches += 1
    phase_launches[phase] += 1
    return y


def _zrun_conv_setup(ctx, inputs, output):
    x, w, zbase, zcode, out_valid, _ = inputs
    ctx.save_for_backward(x, w, zbase, zcode, out_valid)


def _zrun_conv_backward(ctx, dy):
    """The scatter-free symmetric-stencil backward: dx is the same conv
    (through :func:`zrun_conv`, so the kernel on the card) on the masked dy
    with ``flip_k(W)^T``, dW the plain re-gather; saves only the input, W
    and the plan."""
    x, w, zbase, zcode, out_valid = ctx.saved_tensors
    if out_valid is not None:
        dy = torch.where(out_valid[:, None], dy, 0)
    dy = dy.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = zrun_conv(dy, w.flip(0).transpose(1, 2), zbase, zcode,
                       phase="bwd").to(x.dtype)
    if ctx.needs_input_grad[1]:
        dw = sparse.ztriple_weight_grad(x, zbase, zcode, dy).to(w.dtype)
    return dx, dw, None, None, None, None


_zrun_conv_op.register_autograd(_zrun_conv_backward,
                                setup_context=_zrun_conv_setup)


def reset_counts() -> None:
    """Set every launch count to 0."""
    global launches
    launches = 0
    for k in phase_launches:
        phase_launches[k] = 0


def zrun_conv_sym(x: torch.Tensor, w: torch.Tensor, zbase: torch.Tensor,
                  zcode: torch.Tensor,
                  out_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`zrun_conv` on the training path, the counterpart of
    ``pallas_zt_conv_sym``: dx launches the same kernel on the masked dy
    with ``flip_k(W)^T`` (the plain version on the CPU), dW is
    ``ops/sparse.ztriple_weight_grad``."""
    return zrun_conv(x, w, zbase, zcode, out_valid)
