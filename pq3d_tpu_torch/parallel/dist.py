"""Process groups and the reductions over the batch's rows;
counterpart of ``pq3d_tpu/parallel/multihost.py`` and of the ``data``
axis of ``pq3d_tpu/parallel/mesh.py``.

The JAX package runs one controller: its batch is one logical array under
``jit``, so every reduction over the batch is global.  Here each process
(a rank) holds one slice of the global batch, so what reduces over the
batch says so: the masked batch norms sum their statistics over the
ranks that hold rows (``all_reduce_sum``, with autograd), the losses
divide by counts summed over them (``global_sum``), and the evaluators
merge what they scored (``merge_eval_dicts``, ``gather_in_order``).

Which ranks hold rows is the mesh's business (``parallel/mesh.py``): the
rows split over its ``data x fsdp`` ranks, the row group, and the ``tp``
peers of a rank share its rows.  ``make_mesh`` registers the mesh here
(``set_mesh``); the helpers then reduce over the rank's row group, and
the evaluator merges take only tp-rank 0 of each row group, since its tp
peers score the same rows.  ``rows()`` / ``row_index()`` are the size of
the row group and the rank's place in it.  Without a mesh every rank
holds rows (``rows() == world()``); without a process group every helper
is the identity and ``rank()`` / ``world()`` are 0 / 1, so one process
computes exactly what it computed before this module.  ``any_rank``
agrees over every rank: a preemption flag must stop tp peers too.

Object collectives (``all_gather_object``, ``gather_object``,
``broadcast_object``) pickle through the backend's own device: CPU tensors
under gloo (which all-gathers no CUDA tensor), the rank's card under nccl.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if is_initialized() else 1


# the mesh registered by parallel/mesh.make_mesh (None: every rank holds
# rows of its own)
_MESH: List[Any] = [None]


def set_mesh(mesh: Any) -> None:
    """Register ``mesh`` (a ``parallel.mesh.Mesh``, or None to drop it):
    the reductions below then run over its row group."""
    _MESH[0] = mesh


def get_mesh() -> Any:
    return _MESH[0]


def rows() -> int:
    """The ranks that hold different rows of the batch (data x fsdp)."""
    m = _MESH[0]
    return m.n_rows if m is not None else world()


def row_index() -> int:
    """This rank's place among them: which rows of the batch it holds."""
    m = _MESH[0]
    return m.row_index if m is not None else rank()


def _row_group():
    """The process group of this rank's row group (None: every rank)."""
    m = _MESH[0]
    return m.row_group if m is not None else None


def env_ranks(mode: str, environ: Mapping[str, str] = os.environ
              ) -> Dict[str, Any]:
    """``rank``, ``world``, ``local_rank``, ``local_world``, ``addr`` and
    ``port`` of this process from the environment: ``dist`` reads
    torchrun's (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), ``slurm``
    SLURM's (``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID``,
    ``SLURM_NTASKS_PER_NODE``; the address from ``MASTER_ADDR`` or the
    node that ran ``srun``, ``SLURM_LAUNCH_NODE_IPADDR``; the port from
    ``MASTER_PORT`` or the job id).  A missing value is None."""
    def get(key, cast=int):
        v = environ.get(key)
        return None if v in (None, "") else cast(v)

    if mode == "dist":
        return {"rank": get("RANK"), "world": get("WORLD_SIZE"),
                "local_rank": get("LOCAL_RANK"),
                "local_world": get("LOCAL_WORLD_SIZE"),
                "addr": get("MASTER_ADDR", str), "port": get("MASTER_PORT")}
    if mode == "slurm":
        per_node = environ.get("SLURM_NTASKS_PER_NODE")
        job = get("SLURM_JOB_ID")
        port = get("MASTER_PORT")
        if port is None and job is not None:
            port = 20000 + job % 20000
        return {"rank": get("SLURM_PROCID"), "world": get("SLURM_NTASKS"),
                "local_rank": get("SLURM_LOCALID"),
                # "4" or "4(x2)": tasks on each node
                "local_world": (int(per_node.split("(")[0])
                                if per_node else None),
                "addr": (get("MASTER_ADDR", str)
                         or get("SLURM_LAUNCH_NODE_IPADDR", str)),
                "port": port}
    raise ValueError(f"no rank environment for mode {mode!r}")


def init_process_group(backend: str, rank: int, world: int, addr: str,
                       port: int, timeout_s: float = 1800.0) -> None:
    """Join the group ``tcp://addr:port`` as ``rank`` of ``world`` over
    ``backend`` (``nccl`` or ``gloo``; nothing picks or swaps it here)."""
    missing = [k for k, v in (("rank", rank), ("world", world),
                              ("addr", addr), ("port", port)) if v is None]
    if missing:
        raise ValueError(f"init_process_group needs {missing}: pass them "
                         f"or run under torchrun / srun")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=int(rank), world_size=int(world),
                            timeout=timedelta(seconds=timeout_s))


def destroy_process_group() -> None:
    set_mesh(None)
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def _collective_device() -> torch.device:
    """Where a tensor collective's operand lives: the rank's card under
    nccl, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=_row_group())
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=_row_group())
        return grad


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the row group, differentiable: the backward
    sums the gradient over it, so a rank's gradient holds what every
    rank's loss owes to its rows."""
    if rows() == 1:
        return t
    return _AllReduceSum.apply(t)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the row group, as a constant (loss
    normalisers: counts over the global batch)."""
    if rows() == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=_row_group())
    return t


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any (an all-reduce max),
    so every rank takes the same branch before a collective."""
    if world() == 1:
        return bool(flag)
    t = torch.tensor([int(flag)], device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order."""
    if world() == 1:
        return [obj]
    out: List[Any] = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def gather_object(obj: Any, dst: int = 0) -> Optional[List[Any]]:
    """Every rank's ``obj`` in rank order on ``dst``; None elsewhere."""
    if world() == 1:
        return [obj]
    out: Optional[List[Any]] = [None] * world() if rank() == dst else None
    dist.gather_object(obj, out, dst=dst)
    return out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``src``'s ``obj`` on every rank."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def _scorers(every: List[Any]) -> List[Any]:
    """The entries of tp-rank 0 of each row group, in row order, from a
    list in rank order (the mesh lays ranks out row-major, tp last)."""
    m = _MESH[0]
    return every if m is None else every[::m.cfg.tp]


def merge_eval_dicts(eval_dict: Dict[str, List]) -> Dict[str, List]:
    """The evaluator ``(value, count)`` pairs of every row, row-major (the
    JAX package's ``merge_eval_dicts``)."""
    if world() == 1:
        return eval_dict
    merged: Dict[str, List] = {}
    for d in _scorers(all_gather_object(eval_dict)):
        for k, pairs in d.items():
            merged.setdefault(k, []).extend(pairs)
    return merged


def gather_in_order(chunks: List[List[Any]]) -> Optional[List[Any]]:
    """The items every rank recorded, on rank 0 in the order one process
    meets them over the global batches: ``chunks`` holds one list per
    evaluator update (one global batch), and the merge takes update u of
    rank 0, of rank 1, ..., then update u + 1.  A rank with no real rows in
    the last, wrap-padded batch has one update fewer, at the end, so the
    order holds.  None on the other ranks."""
    every = gather_object(chunks)
    if every is None:
        return None
    every = _scorers(every)
    out: List[Any] = []
    for u in range(max(len(c) for c in every)):
        for c in every:
            if u < len(c):
                out.extend(c[u])
    return out


def param_checksum(module: torch.nn.Module) -> int:
    """An integer sum of the bits of every parameter and buffer, weighted
    by their place: ranks whose checksums differ hold different weights
    (equal checksums are what bit-identical weights give)."""
    return tensor_checksum(list(module.parameters())
                           + list(module.buffers()))


def tensor_checksum(tensors: List[torch.Tensor]) -> int:
    """``param_checksum`` of a list of tensors."""
    total = 0
    for i, t in enumerate(tensors):
        t = t.detach().contiguous().reshape(-1)
        ints = {8: torch.int64, 4: torch.int32, 2: torch.int16,
                1: torch.uint8}[t.element_size()]
        total += (i + 1) * int(t.view(ints).sum(dtype=torch.int64).item())
    return total
