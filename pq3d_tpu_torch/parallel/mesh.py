"""The ``data x fsdp x tp`` mesh over a process group; counterpart of
``pq3d_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a ``(data, fsdp, tp)`` array,
places each parameter by a ``PartitionSpec`` (``param_spec``) and lets XLA
insert the collectives.  The port runs one process (a rank) per device, so
it lays the ranks out the same way, row-major (``rank = (d * fsdp + f) *
tp + t``), and does the collectives itself:

- **Placement.** ``tp_spec`` and ``param_spec`` are JAX's rules, on the
  flax path and the flax-layout shape that ``utils/weights.param_paths``
  gives each torch parameter; ``placements`` turns the spec into the torch
  layout (an ``nn.Linear`` weight is the flax kernel transposed, so
  column-parallel is its dim 0 and row-parallel its dim 1; a sparse conv's
  ``(K, Cin, Cout)`` keeps its layout).  A placement is one entry per dim:
  ``None``, ``"fsdp"`` or ``"tp"``.
- **Rows.** The batch's rows split over the ``data x fsdp`` ranks (the row
  group, ``parallel/dist.rows``), as ZeRO-3 splits them; the tp peers of a
  rank share its rows.  JAX splits rows over ``data`` only and replicates
  them over ``fsdp``; the global batch, the loss and the update are the
  same either way.
- **FSDP** (``Sharding``, the port's own hooks rather than torch's
  ``fully_shard``, so the placement is exactly ``param_spec``'s).  Each
  rank keeps only its shard of an fsdp-placed parameter, of its gradient
  and of its AdamW moments (the optimizer is built on the same parameter
  objects, so it makes its moments in the shard's shape).  The whole model
  is one unit: ``gathered`` all-gathers every shard over the fsdp group
  (one ``all_gather_into_tensor`` a dtype) just before the forward, the
  forward and the backward run on the gathered tensors, and the shards
  come back right after the backward.  ``reduce_grads`` then sums every
  gradient over the ranks that must add it and keeps the rank's block,
  as JAX's step does: an fsdp-placed gradient is reduce-scattered over
  the fsdp group (``reduce_scatter_tensor``) and its shard all-reduced
  over the ranks that hold the same shard; any other is all-reduced.  A
  parameter no tp rule shards gets its gradient summed over its tp peers
  too and divided by ``tp``: they computed the same gradient, and the sum
  keeps them bit-identical.
- **Tensor parallelism** (``parallel/tp.py``): Megatron's column- and
  row-parallel products on the parameters ``tp_spec`` shards.

**Collectives.** Each is ``torch.distributed``'s own on a copy of the
tensor where it lives: under nccl on the card; under gloo (two ranks on
one card, or the host) gloo takes CUDA tensors as they are and moves them
through the host itself.  ``make_mesh`` prints the backend.  Nothing
switches it.

Checkpoints hold the gathered state (``full_state_dict``,
``full_optimizer_state``) in one process's format, so a checkpoint saved
under any mesh resumes under any other: the trainer restores a full state
into the whole model before ``shard_params`` cuts it, and
``Sharding.shard_optimizer_state`` cuts the restored AdamW moments.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn as nn

from pq3d_tpu_torch.parallel import dist

Placement = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The config's ``parallel:`` node: ``data`` (-1: every rank the
    other axes leave), ``fsdp``, ``tp`` and ``fsdp_min_size`` (only
    parameters of at least this many elements are fsdp-sharded)."""
    data: int = -1
    fsdp: int = 1
    tp: int = 1
    fsdp_min_size: int = 2 ** 16

    @classmethod
    def from_config(cls, cfg: Mapping[str, Any]) -> "MeshConfig":
        node = cfg.get("parallel") or {}
        return cls(data=int(node.get("data", -1)),
                   fsdp=int(node.get("fsdp", 1)), tp=int(node.get("tp", 1)),
                   fsdp_min_size=int(node.get("fsdp_min_size", 2 ** 16)))

    def resolve(self, world: int) -> "MeshConfig":
        """``data`` made concrete for ``world`` ranks; raises unless
        ``data x fsdp x tp`` is the world."""
        if self.fsdp < 1 or self.tp < 1:
            raise ValueError(f"parallel.fsdp={self.fsdp} and parallel.tp="
                             f"{self.tp} must be at least 1")
        data = self.data if self.data > 0 else world // (self.fsdp * self.tp)
        if data * self.fsdp * self.tp != world:
            raise ValueError(
                f"parallel.data={self.data} x fsdp={self.fsdp} x tp="
                f"{self.tp} does not make the run's {world} ranks")
        return dataclasses.replace(self, data=data)

    @property
    def sharded(self) -> bool:
        return self.fsdp > 1 or self.tp > 1


# Megatron-style tensor-parallel rules keyed on flax param-path fragments
# (the JAX package's, verbatim): column-parallel (shard output features)
# and row-parallel (shard input features)
_TP_COL = ("q_proj/", "k_proj/", "v_proj/", "w_qs/", "w_ks/", "w_vs/",
           "/q/", "/k/", "/v/", "/wi/", "FFNLayer_0/Dense_0/",
           "Dense_0/kernel")
_TP_ROW = ("out_proj/", "/o/", "/wo/", "Dense_1/kernel")


def tp_spec(path: str, shape: Tuple[int, ...], cfg: MeshConfig
            ) -> Optional[Tuple[Optional[str], ...]]:
    """Tensor-parallel spec of a flax path and flax-layout shape (JAX's
    ``tp_spec``): a tuple as ``PartitionSpec`` holds it, ``()`` for
    replicated, or None when no rule matches."""
    ndim = len(shape)
    if cfg.tp <= 1 or ndim == 0:
        return None
    is_col = any(f in path for f in _TP_COL)
    is_row = any(f in path for f in _TP_ROW)
    if not (is_col or is_row):
        return None
    if ndim == 1:    # bias
        if is_col and shape[0] % cfg.tp == 0:
            return ("tp",)
        return ()
    axis = ndim - 1 if is_col else ndim - 2
    if shape[axis] % cfg.tp != 0:
        return None
    spec: List[Optional[str]] = [None] * ndim
    spec[axis] = "tp"
    return tuple(spec)


def param_spec(path: str, shape: Tuple[int, ...], cfg: MeshConfig
               ) -> Tuple[Optional[str], ...]:
    """JAX's ``param_spec``: tp where a Megatron rule matches, then fsdp on
    the largest dim no rule took of a parameter of at least
    ``fsdp_min_size`` elements; ``()`` for replicated."""
    ndim = len(shape)
    tp = tp_spec(path, shape, cfg)
    spec = list(tp) if tp is not None else []
    spec += [None] * (ndim - len(spec))
    if ndim < 1 or math.prod(shape) < cfg.fsdp_min_size or cfg.fsdp <= 1:
        return tuple(spec) if tp is not None else ()
    dims = [(-1 if spec[i] is not None else shape[i]) for i in range(ndim)]
    axis = int(np.argmax(dims))
    if spec[axis] is None and shape[axis] % cfg.fsdp == 0:
        spec[axis] = "fsdp"
    return tuple(spec)


def placements(model: nn.Module, cfg: MeshConfig) -> Dict[str, Placement]:
    """Every parameter's placement in the torch layout, by dotted name:
    one entry per dim (``None``, ``"fsdp"``, ``"tp"``); all ``None`` is
    replicated."""
    from pq3d_tpu_torch.utils.weights import param_paths
    out = {}
    for name, path, shape, flip in param_paths(model):
        spec = param_spec("/".join(path) + "/", shape, cfg)
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        out[name] = spec[::-1] if flip else spec
    return out


def _dim(placement: Placement, axis: str) -> Optional[int]:
    return placement.index(axis) if axis in placement else None


class Mesh:
    """One rank's view of the mesh: its coordinates ``(d, f, t)``, the
    process groups it belongs to (``row_group``: the ranks with its tp
    index, data x fsdp of them; ``fsdp_group``; ``tp_group``;
    ``data_group``: its fsdp and tp index; ``shard_group``: its fsdp
    index, data x tp ranks) and the group's backend."""

    def __init__(self, cfg: MeshConfig, rank: int, groups: Dict[str, Any],
                 backend: str):
        self.cfg = cfg
        self.rank = rank
        self.world = cfg.data * cfg.fsdp * cfg.tp
        d, f, t = np.unravel_index(rank, (cfg.data, cfg.fsdp, cfg.tp))
        self.coords = (int(d), int(f), int(t))
        self.row_index = int(d) * cfg.fsdp + int(f)
        self.n_rows = cfg.data * cfg.fsdp
        self.tp_rank = int(t)
        self.fsdp_rank = int(f)
        self.row_group = groups.get("rows")
        self.fsdp_group = groups.get("fsdp")
        self.tp_group = groups.get("tp")
        self.data_group = groups.get("data")
        self.shard_group = groups.get("shard")
        self.backend = backend

    def describe(self) -> str:
        c = self.cfg
        return (f"mesh data={c.data} x fsdp={c.fsdp} x tp={c.tp} "
                f"(fsdp_min_size {c.fsdp_min_size}); rank {self.rank} at "
                f"{self.coords}, row {self.row_index} of {self.n_rows}; "
                f"collectives: {self.backend}")

    # ---------------------------------------------------- collectives

    def all_reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        """The sum of ``t`` over ``group`` (None: every rank), a new
        tensor on ``t``'s device; ``t`` is left as it was."""
        out = t.detach().clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(out, group=group)
        return out

    def all_gather(self, t: torch.Tensor, group, size: int
                   ) -> torch.Tensor:
        """Every rank's ``t`` (same shape) in ``group``, stacked on a new
        dim 0 in rank order."""
        flat = t.detach().reshape(-1).contiguous()
        out = flat.new_empty(size * flat.numel())
        tdist.all_gather_into_tensor(out, flat, group=group)
        return out.view(size, *t.shape)

    def reduce_scatter(self, t: torch.Tensor, group, size: int
                       ) -> torch.Tensor:
        """The sum over ``group`` of ``t`` (a flat tensor of ``size``
        equal blocks): this rank's block."""
        flat = t.detach().reshape(-1).contiguous()
        out = flat.new_empty(flat.numel() // size)
        tdist.reduce_scatter_tensor(out, flat, group=group)
        return out


def make_mesh(cfg: MeshConfig = MeshConfig()) -> Mesh:
    """The mesh of the current process group (one rank without one),
    registered with ``parallel/dist`` so its reductions run over the row
    group (and dropped there by ``dist.destroy_process_group``).  Every
    rank must call it: it creates the groups."""
    world = dist.world()
    cfg = cfg.resolve(world)
    groups: Dict[str, Any] = {}
    backend = "none"
    if world > 1:
        backend = tdist.get_backend()
        ranks = np.arange(world).reshape(cfg.data, cfg.fsdp, cfg.tp)
        layouts = {
            "rows": ranks.transpose(2, 0, 1).reshape(cfg.tp, -1),
            "fsdp": ranks.transpose(0, 2, 1).reshape(-1, cfg.fsdp),
            "tp": ranks.reshape(-1, cfg.tp),
            "data": ranks.transpose(1, 2, 0).reshape(-1, cfg.data),
            "shard": ranks.transpose(1, 0, 2).reshape(cfg.fsdp, -1),
        }
        me = dist.rank()
        for kind, rows in layouts.items():
            if rows.shape[1] == world:          # every rank: the default
                groups[kind] = None
                continue
            for members in rows:
                g = tdist.new_group([int(r) for r in members])
                if me in members:
                    groups[kind] = g
    mesh = Mesh(cfg, dist.rank(), groups, backend)
    dist.set_mesh(mesh if world > 1 else None)
    return mesh


# ------------------------------------------------------------ sharding

def _local_slice(t: torch.Tensor, placement: Placement, mesh: Mesh
                 ) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``placement``."""
    for axis, idx, n in (("fsdp", mesh.fsdp_rank, mesh.cfg.fsdp),
                         ("tp", mesh.tp_rank, mesh.cfg.tp)):
        d = _dim(placement, axis)
        if d is not None:
            t = t.chunk(n, dim=d)[idx]
    return t.contiguous()


def _bucketed_gather(mesh: Mesh, tensors: List[torch.Tensor],
                     dims: List[int], group, size: int
                     ) -> List[torch.Tensor]:
    """Each of ``tensors`` all-gathered over ``group`` and concatenated
    on its dim of ``dims``: one all-gather a dtype."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        parts = mesh.all_gather(flat, group, size)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            shape = tensors[i].shape
            out[i] = torch.cat([p[off:off + n].view(shape) for p in parts],
                               dim=dims[i])
            off += n
    return out  # type: ignore[return-value]


def gather_full(mesh: Mesh, tensors: List[torch.Tensor],
                places: List[Placement]) -> List[torch.Tensor]:
    """The full tensors of local blocks ``tensors`` under ``places``:
    gathered over fsdp, then over tp."""
    out = list(tensors)
    for axis, group, size in (("fsdp", mesh.fsdp_group, mesh.cfg.fsdp),
                              ("tp", mesh.tp_group, mesh.cfg.tp)):
        idx = [i for i, p in enumerate(places) if axis in p]
        if not idx or size == 1:
            continue
        full = _bucketed_gather(mesh, [out[i] for i in idx],
                                [_dim(places[i], axis) for i in idx],
                                group, size)
        for i, t in zip(idx, full):
            out[i] = t
    return out


class Sharding:
    """A model's parameters placed on a mesh (``shard_params``): the
    placements, the FSDP gather around a step, the gradients' reduction,
    the global gradient norm, and the full state for checkpoints."""

    def __init__(self, model: nn.Module, mesh: Mesh):
        self.model = model
        self.mesh = mesh
        self.placements = placements(model, mesh.cfg)
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self._place = {id(p): self.placements[n]
                       for n, p in zip(self.names, self.params)}
        self._fsdp = [i for i, n in enumerate(self.names)
                      if "fsdp" in self.placements[n]]
        # gradients taken off the fsdp-sharded parameters on leaving
        # ``gathered``, by parameter id
        self._taken: Dict[int, Optional[torch.Tensor]] = {}
        with torch.no_grad():
            for n, p in zip(self.names, self.params):
                if any(self.placements[n]):
                    p.data = _local_slice(p.data, self.placements[n], mesh)

    def placement(self, p: torch.Tensor) -> Placement:
        return self._place[id(p)]

    # ------------------------------------------------------- FSDP

    @contextlib.contextmanager
    def gathered(self) -> Iterator[None]:
        """Inside the block every fsdp-sharded parameter holds its
        gathered (tp-local) tensor; on leaving, its shard again.  A
        gradient the block's backward left on such a parameter is taken
        off first, in the gathered shape: ``take_grads`` reads it."""
        if not self._fsdp or self.mesh.cfg.fsdp == 1:
            yield
            return
        params = [self.params[i] for i in self._fsdp]
        shards = [p.data for p in params]
        full = _bucketed_gather(
            self.mesh, shards,
            [_dim(self.placement(p), "fsdp") for p in params],
            self.mesh.fsdp_group, self.mesh.cfg.fsdp)
        for p, t in zip(params, full):
            p.data = t
        try:
            yield
        finally:
            for p, s in zip(params, shards):
                self._taken[id(p)] = p.grad
                p.grad = None
                p.data = s

    def local_grads(self, params: List[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """The gradients the backward left, in the compute shape (the
        gathered one for an fsdp-sharded parameter), taken off the
        parameters; zeros where the loss did not reach one."""
        out = []
        for p in params:
            g = self._taken.pop(id(p)) if id(p) in self._taken else p.grad
            p.grad = None
            if g is None:
                shape = list(p.shape)
                d = _dim(self.placement(p), "fsdp")
                if d is not None:
                    shape[d] *= self.mesh.cfg.fsdp
                g = torch.zeros(shape, dtype=p.dtype, device=p.device)
            out.append(g)
        return out

    def reduce_grads(self, params: List[torch.Tensor],
                     grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """``grads`` (each rank's, in the compute shape) summed over the
        ranks whose rows they came from, each cut to the rank's block: a
        tp-sharded parameter's over its row group, any other's over every
        rank divided by ``tp`` (its tp peers computed the same).  An
        fsdp-sharded one is reduce-scattered over the fsdp group first and
        its shard then all-reduced over the ranks that hold that shard.
        One collective a kind, group and dtype, in the parameters' order
        (the same on every rank)."""
        mesh = self.mesh
        out = list(grads)
        buckets: Dict[Tuple[bool, bool, torch.dtype], List[int]] = {}
        for i, p in enumerate(params):
            pl = self.placement(p)
            fsdp = "fsdp" in pl and mesh.cfg.fsdp > 1
            buckets.setdefault(("tp" in pl, fsdp, grads[i].dtype),
                               []).append(i)
        for (tp, fsdp, _), idx in buckets.items():
            if fsdp:
                size = mesh.cfg.fsdp
                blocks = [[grads[i].chunk(size, dim=_dim(
                    self.placement(params[i]), "fsdp"))[j].reshape(-1)
                    for i in idx] for j in range(size)]
                flat = mesh.reduce_scatter(
                    torch.cat([torch.cat(b) for b in blocks]),
                    mesh.fsdp_group, size)
                shapes = [blocks[mesh.fsdp_rank][k].numel() for k in
                          range(len(idx))]
                rest, rest_size = ((mesh.data_group, mesh.cfg.data) if tp
                                   else (mesh.shard_group,
                                         mesh.cfg.data * mesh.cfg.tp))
            else:
                flat = torch.cat([grads[i].reshape(-1) for i in idx])
                shapes = [grads[i].numel() for i in idx]
                rest, rest_size = ((mesh.row_group, mesh.n_rows) if tp
                                   else (None, mesh.world))
            if rest_size > 1:
                flat = mesh.all_reduce(flat, rest)
            if not tp and mesh.cfg.tp > 1:
                flat = flat / mesh.cfg.tp
            off = 0
            for i, n in zip(idx, shapes):
                shape = list(grads[i].shape)
                if fsdp:
                    shape[_dim(self.placement(params[i]), "fsdp")] //= \
                        mesh.cfg.fsdp
                out[i] = flat[off:off + n].view(shape)
                off += n
        return out

    def global_norm(self, params: List[torch.Tensor],
                    grads: List[torch.Tensor]) -> torch.Tensor:
        """The norm of the whole model's gradient from the ranks' blocks
        (each element once): every block's sum of squares over the
        number of ranks that hold the same block, summed over every
        rank."""
        mesh = self.mesh
        sq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for p, g in zip(params, grads):
            pl = self.placement(p)
            blocks = (mesh.cfg.fsdp if "fsdp" in pl else 1) * \
                (mesh.cfg.tp if "tp" in pl else 1)
            sq = sq + torch.linalg.vector_norm(g.float()).square() \
                * (blocks / mesh.world)
        if mesh.world > 1:
            sq = mesh.all_reduce(sq, None)
        return sq.sqrt()

    # ---------------------------------------------- checkpoint state

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with every parameter gathered (every
        rank gets it)."""
        state = self.model.state_dict()
        names = [n for n in self.names if any(self.placements[n])]
        full = gather_full(self.mesh, [state[n] for n in names],
                           [self.placements[n] for n in names])
        state.update(zip(names, full))
        return state

    def full_optimizer_state(self, optimizer: torch.optim.Optimizer
                             ) -> Dict[str, Any]:
        """``optimizer.state_dict()`` with every per-parameter tensor of a
        sharded parameter gathered (every rank gets it)."""
        sd = optimizer.state_dict()
        order = [p for g in optimizer.param_groups for p in g["params"]]
        keys, tensors, places = [], [], []
        for i, st in sd["state"].items():
            p = order[i]
            pl = self.placement(p)
            if not any(pl):
                continue
            for k, v in st.items():
                if torch.is_tensor(v) and v.shape == p.shape:
                    keys.append((i, k))
                    tensors.append(v)
                    places.append(pl)
        full = gather_full(self.mesh, tensors, places)
        state = {i: dict(st) for i, st in sd["state"].items()}
        for (i, k), t in zip(keys, full):
            state[i][k] = t
        return {"state": state, "param_groups": sd["param_groups"]}

    def shard_optimizer_state(self, optimizer: torch.optim.Optimizer
                              ) -> None:
        """Cut the optimizer's per-parameter tensors that still have the
        full shape (loaded from a full checkpoint) to the rank's block."""
        for group in optimizer.param_groups:
            for p in group["params"]:
                pl = self.placement(p)
                st = optimizer.state.get(p)
                if not st or not any(pl):
                    continue
                for k, v in st.items():
                    if torch.is_tensor(v) and v.dim() == p.dim() and \
                            v.shape != p.shape:
                        st[k] = _local_slice(v, pl, self.mesh)

    def replicated_checksum(self) -> int:
        """``dist.tensor_checksum`` of the parameters no rule shards and
        of the buffers: equal on the tp peers of a row group."""
        rep = [p for p in self.params if not any(self.placement(p))]
        return dist.tensor_checksum(rep + list(self.model.buffers()))


def shard_params(model: nn.Module, mesh: Mesh) -> Sharding:
    """Place ``model``'s parameters on ``mesh`` in place (each rank keeps
    its blocks) and, with ``tp > 1``, switch the layers ``tp_spec`` shards
    to tensor-parallel compute (``parallel/tp.install``).  The model's
    ``sharding`` attribute holds the result."""
    sharding = Sharding(model, mesh)
    if mesh.cfg.tp > 1:
        from pq3d_tpu_torch.parallel import tp
        tp.install(model, mesh, sharding.placements)
    object.__setattr__(model, "sharding", sharding)
    return sharding


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's full state dict, gathered when it is sharded."""
    sharding = getattr(model, "sharding", None)
    return model.state_dict() if sharding is None \
        else sharding.full_state_dict()


def replicate(model: nn.Module, devices: List[Any]) -> List[nn.Module]:
    """One copy of ``model`` on each of ``devices`` (a device may repeat:
    each entry gets its own copy), all holding the same weights (JAX's
    ``replicate``)."""
    import copy
    return [copy.deepcopy(model).to(torch.device(d)) for d in devices]
