"""Exact linear sum assignment on the card: plain version and the wrapper of
the hand-written CUDA kernel.

Counterpart of ``pq3d_tpu/ops/hungarian.py``, the JAX package's on-device
Jonker-Volgenant solver (shortest augmenting paths: a ``lax.scan`` over
rows around two ``lax.while_loop``s, vmapped over lanes).  It replaces no
Pallas kernel: the stage-1 set loss matches every (round, scene) with it,
so the train step copies nothing to the host (scipy's
``linear_sum_assignment``, which the reference calls, needs the costs
there).

``solve(cost)``, cost (R, N) f32 with R <= N, minimises and returns
``col4row`` (R,) int32, the column of every row; ``solve_batch`` does the
same for (L, R, N) -> (L, R), lane by lane.  Padded rows are given a
constant cost: such a row is indifferent to its column, so the real rows'
assignment is an optimal one of the real rows alone.

On a CPU tensor :func:`solve_batch` runs ``csrc/hungarian_cpu.cpp``, the
same solver in C++ (built by g++ with ``-ffp-contract=off`` and without
``-ffast-math``, so no float operation is fused or reordered); on a CUDA
tensor it launches ``csrc/hungarian.cu`` (one warp a lane), which pins the
order with round-to-nearest intrinsics.  Both repeat JAX's arithmetic in
its f32 operation order, as the plain version :func:`solve_batch_reference`
does step by step, so ``col4row`` equals JAX's on every row, ties and
padded rows included.  A failed build or launch raises, and there is no
fallback.

Loops are bounded: at most N Dijkstra steps an augmentation and R steps a
path walk.  Finite costs never reach those caps.  A lane that does (only
non-finite costs can: JAX's ``while_loop`` then spins forever), or whose
path walk meets a column with no predecessor or a row with no column,
fails: it stops, and its ``col4row`` is -1 on every row.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np
import torch

from pq3d_tpu_torch._build import CSRC_DIR, NVCC_FLAGS, build_shared, nvcc

INF = 1e30          # the JAX package's _INF: an unreached column's min_val
MAX_COLS = 1024     # the widest problem the kernel takes (32 columns a lane)
SMEM_LIMIT = 232448  # shared memory a block may use (227 KB)

# launches of the CUDA kernel since the last reset (a plain counter that
# smoke runs set to 0 before a path and read after it)
launches = 0

_SRC = os.path.join(CSRC_DIR, "hungarian.cu")
_CPU_SRC = os.path.join(CSRC_DIR, "hungarian_cpu.cpp")
_LOCK = threading.Lock()
_LIB = None
_CPU_LIB = None
# no -march=native: GCC then fuses multiply-adds by default, and
# -ffp-contract=off forbids any such contraction
CPU_FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17"]
build_log = ""       # the compiler's output of the loaded library's build


def staged(rows: int, cols: int) -> bool:
    """Does the kernel copy a lane's costs to shared memory (with u,
    col4row and row4col)?  Else it reads each row from global memory."""
    return (rows * cols + 2 * rows + cols) * 4 <= SMEM_LIMIT


def _check(cost: torch.Tensor, ndim: int, steps: Optional[torch.Tensor]):
    if cost.dim() != ndim:
        raise ValueError(f"hungarian: cost must be {ndim}-D, got "
                         f"{tuple(cost.shape)}")
    if cost.dtype != torch.float32:
        raise TypeError(f"hungarian: cost must be float32, got {cost.dtype}")
    if cost.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hungarian: unsupported device {cost.device}")
    if not cost.is_contiguous():
        raise ValueError("hungarian: cost must be contiguous")
    r, n = cost.shape[-2:]
    if r > n:
        raise ValueError(f"hungarian: rows {r} > cols {n} (transpose the "
                         f"cost)")
    if n > MAX_COLS:
        raise ValueError(f"hungarian: {n} columns; the kernel takes at "
                         f"most {MAX_COLS}")
    if steps is not None and (steps.shape != cost.shape[:1]
                              or steps.dtype != torch.int32
                              or not steps.is_contiguous()
                              or steps.device != cost.device):
        raise ValueError("hungarian: steps must be (L,) int32 on the "
                         "cost's device")


def solve_batch_reference(cost: torch.Tensor):
    """Plain PyTorch version of the kernel: (L, R, N) f32 -> (col4row (L,
    R) int32, Dijkstra steps (L,) int32), JAX's ``solve`` with every lane
    in lockstep (a lane that is done waits under a mask) and the caps and
    failure rule of the module docstring."""
    nl, nr, nc = cost.shape
    dev = cost.device
    lanes = torch.arange(nl, device=dev)
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    u = torch.zeros(nl, nr, device=dev)
    v = torch.zeros(nl, nc, device=dev)
    col4row = torch.full((nl, nr), -1, dtype=torch.long, device=dev)
    row4col = torch.full((nl, nc), -1, dtype=torch.long, device=dev)
    failed = torch.zeros(nl, dtype=torch.bool, device=dev)
    steps = torch.zeros(nl, dtype=torch.long, device=dev)
    for cur in range(nr):
        # ---- Dijkstra over columns from row cur --------------------------
        min_val = torch.full((nl, nc), INF, device=dev)
        scanned = torch.zeros(nl, nc, dtype=torch.bool, device=dev)
        path = torch.full((nl, nc), -1, dtype=torch.long, device=dev)
        i = torch.full((nl,), cur, dtype=torch.long, device=dev)
        lowest = torch.zeros(nl, device=dev)
        sink = torch.full((nl,), -1, dtype=torch.long, device=dev)
        active = ~failed
        for _ in range(nc):
            if not bool(active.any()):
                break
            red = ((lowest[:, None] + cost[lanes, i]) - u[lanes, i][:, None]
                   ) - v
            better = (red < min_val) & ~scanned & active[:, None]
            min_val = torch.where(better, red, min_val)
            path = torch.where(better, i[:, None], path)
            masked = torch.where(scanned, inf, min_val)
            j = masked.argmin(1)            # the first index wins ties
            lowest = torch.where(active, masked[lanes, j], lowest)
            scanned[lanes[active], j[active]] = True
            nxt = row4col[lanes, j]
            steps += active
            sink = torch.where(active & (nxt < 0), j, sink)
            i = torch.where(active & (nxt >= 0), nxt, i)
            active = active & (nxt >= 0)
        failed |= active                    # N steps, no free column
        ok = ~failed
        # ---- dual update: u[cur] first, then the tree's rows and columns -
        u[ok, cur] = u[ok, cur] + lowest[ok]
        d = lowest[:, None] - min_val
        tree = scanned & (row4col >= 0) & ok[:, None]
        flat = (lanes[:, None] * nr + row4col.clamp_min(0))[tree]
        uf = u.view(-1)
        uf[flat] = uf[flat] + d[tree]
        v = torch.where(scanned & ok[:, None], v - d, v)
        # ---- augment along the path --------------------------------------
        s = sink
        walking = ok.clone()
        for _ in range(nr):
            if not bool(walking.any()):
                break
            ii = path[lanes, s.clamp_min(0)]
            bad = walking & ((s < 0) | (ii < 0))
            failed |= bad
            walking &= ~bad
            w = lanes[walking]
            prev = col4row[lanes, ii.clamp_min(0)]
            row4col[w, s[w]] = ii[w]
            col4row[w, ii[w]] = s[w]
            walking &= ii != cur
            s = torch.where(walking, prev, s)
        failed |= walking                   # R steps, cur not reached
    col4row[failed] = -1
    return col4row.int(), steps.int()


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
            lib.pq3d_hungarian.argtypes = (
                [ctypes.c_void_p] * 3
                + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p])
            lib.pq3d_hungarian.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def build_cpu() -> ctypes.CDLL:
    """Build (once per source hash) and load the host solver's library;
    a failed build raises."""
    global _CPU_LIB
    if _CPU_LIB is not None:
        return _CPU_LIB
    with _LOCK:
        if _CPU_LIB is None:
            lib = ctypes.CDLL(build_shared(_CPU_SRC, "native", ["g++"],
                                           CPU_FLAGS))
            lib.pq3d_hungarian_cpu.argtypes = (
                [ctypes.c_void_p] * 3
                + [ctypes.c_int64, ctypes.c_int, ctypes.c_int])
            lib.pq3d_hungarian_cpu.restype = ctypes.c_int
            _CPU_LIB = lib
    return _CPU_LIB


def solve_batch(cost: torch.Tensor,
                steps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(L, R, N) f32 costs, R <= N, contiguous -> ``col4row`` (L, R) int32.

    A CPU tensor runs the host solver (``csrc/hungarian_cpu.cpp``); a CUDA
    tensor launches the kernel on the current stream (no synchronise) and
    counts the launch.  ``steps``, an (L,) int32 tensor on the cost's
    device, receives each lane's Dijkstra steps."""
    _check(cost, 3, steps)
    nl, nr, nc = cost.shape
    col4row = torch.empty(nl, nr, dtype=torch.int32, device=cost.device)
    if nl == 0 or nr == 0:
        if steps is not None:
            steps.zero_()
        return col4row
    if cost.device.type == "cpu":
        err = build_cpu().pq3d_hungarian_cpu(
            cost.data_ptr(), col4row.data_ptr(),
            steps.data_ptr() if steps is not None else None, nl, nr, nc)
        if err != 0:
            raise RuntimeError(f"hungarian: host solver refused the shape "
                               f"{tuple(cost.shape)}")
        return col4row
    lib = build()
    stream = torch.cuda.current_stream(cost.device).cuda_stream
    err = lib.pq3d_hungarian(
        cost.data_ptr(), col4row.data_ptr(),
        steps.data_ptr() if steps is not None else None, nl, nr, nc,
        int(staged(nr, nc)), stream)
    if err != 0:
        raise RuntimeError(f"hungarian kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return col4row


def solve(cost: torch.Tensor) -> torch.Tensor:
    """Exact LSA of one (R, N) f32 cost, R <= N -> ``col4row`` (R,) int32."""
    _check(cost, 2, None)
    return solve_batch(cost[None])[0]


def solve_scipy(cost: torch.Tensor) -> torch.Tensor:
    """Host oracle (the JAX package's ``solve_scipy_callback``): (L, R, N)
    -> (L, R) int32 on the cost's device, one scipy
    ``linear_sum_assignment`` a lane, after a copy to the host."""
    from scipy.optimize import linear_sum_assignment
    c = cost.detach().cpu().numpy()
    out = np.zeros(c.shape[:2], dtype=np.int32)
    for b in range(c.shape[0]):
        rows, cols = linear_sum_assignment(c[b])
        out[b, rows] = cols
    return torch.from_numpy(out).to(cost.device)


def reset_counts() -> None:
    """Set the launch count to 0."""
    global launches
    launches = 0
