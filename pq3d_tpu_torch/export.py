"""Ahead-of-time model export: serving artifacts from ``torch.export``.

Counterpart of ``pq3d_tpu/export.py``.  :func:`export_forward` traces the
eval-mode forward of a port model on one example batch with
``torch.export`` and saves the program, its weights included, as bytes;
:func:`load_forward` turns the bytes back into a callable.  The artifact is
shape-specialised, as JAX's is: a batch must match the example's shapes and
dtypes.

Kernel B1 (``ops/zrun_conv``) is the operator ``pq3d::zrun_conv``, and the
trace keeps each routed conv as one node of it.  An artifact exported on a
host without a card therefore launches B1 once it is loaded onto one
(``load_forward(blob, device="cuda")``): build off the card, serve on it.
Kernel B2 (``ops/windowed_conv``) is on no model path, so no exported
forward reaches it.

Here the port parts from JAX's "no model code at all": the serving host
needs this package, since importing ``pq3d_tpu_torch.export`` registers
``pq3d::zrun_conv`` (its plain version, its CUDA launch and its fake shape
rule).  It needs no model class: the program carries the graph.

Typical flow::

    blob = export_forward(model, example_batch)
    Path("model.pt2").write_bytes(blob)
    # serving host (imports pq3d_tpu_torch.export, no model classes):
    fn = load_forward(Path("model.pt2").read_bytes(), device="cuda")
    out = fn(batch)           # the dict the model's forward returns

A forward that reaches a data-dependent shape or a host sync cannot be
traced.  The early-exit decode (``T5Decoder.decode`` with ``early_exit``)
is neither: it is one ``torch.while_loop``, which the program keeps as a
loop (``while_loop_nodes``), as JAX's export keeps its ``lax.while_loop``.
"""
from __future__ import annotations

import io
import threading
import types
import typing
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from pq3d_tpu_torch.ops import zrun_conv  # noqa: F401  registers the op

# the op's name in an exported graph (``node.target``)
ZRUN_CONV_OP = torch.ops.pq3d.zrun_conv.default
_LOAD_LOCK = threading.Lock()   # one load swaps the deserializer's typing


class _Forward(torch.nn.Module):
    """The eval-mode forward of ``model``, its result cut to ``outputs``."""

    def __init__(self, model: torch.nn.Module,
                 outputs: Optional[Sequence[str]]):
        super().__init__()
        self.model = model
        self.outputs = tuple(outputs) if outputs is not None else None

    def forward(self, batch: Dict[str, torch.Tensor]):
        out = self.model(batch)
        if self.outputs is not None:
            out = {k: out[k] for k in self.outputs if k in out}
        return out


def tensor_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The batch's tensors (nested dicts of tensors kept), ``_meta`` and
    every other key dropped: what an exported forward takes."""
    out = {}
    for k, v in batch.items():
        if k.startswith("_"):
            continue
        if isinstance(v, torch.Tensor):
            out[k] = v
        elif isinstance(v, dict):
            sub = tensor_batch(v)
            if sub:
                out[k] = sub
    return out


def export_program(model: torch.nn.Module, example_batch: Dict[str, Any],
                   outputs: Optional[Sequence[str]] = None
                   ) -> torch.export.ExportedProgram:
    """``torch.export`` of ``model``'s eval-mode forward on
    ``example_batch`` (see :func:`export_forward`)."""
    model.eval()
    batch = tensor_batch(example_batch)
    with torch.no_grad():
        program = torch.export.export(_Forward(model, outputs), (batch,),
                                      strict=False)
    # an artifact carries the program and its weights, not the example
    # batch (a stage-1 batch with host maps is some 250 MiB)
    program.example_inputs = None
    return program


def export_forward(model: torch.nn.Module, example_batch: Dict[str, Any],
                   outputs: Optional[Sequence[str]] = None) -> bytes:
    """Serialize ``model``'s eval-mode forward on ``example_batch`` to bytes.

    Args:
      model: a port model (``Query3DUnified`` or any sub-model taking one
        batch dict); it is put in eval mode, and its weights travel in the
        artifact.
      example_batch: the batch that fixes every input shape and dtype, on
        the device the trace should run on (the CPU is enough); ``_meta``
        and non-tensor keys are dropped.
      outputs: optional key subset of the forward's result dict (e.g.
        ``("predictions_class", "predictions_mask")``).
    """
    return save_program(export_program(model, example_batch, outputs))


def save_program(program: torch.export.ExportedProgram) -> bytes:
    """An ``ExportedProgram`` as the bytes of an artifact."""
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


class _TypingWithCachedHints(types.ModuleType):
    """``typing`` with a memoised ``get_type_hints``.  torch.export's
    deserializer resolves the type hints of its schema dataclasses once per
    graph node, which is most of the time of a large program's load (a
    stage-2 program: some 28,000 nodes); the hints of a class never
    change, so each is resolved once."""

    def __init__(self):
        super().__init__("typing")
        self._hints = {}

    def __getattr__(self, name):
        return getattr(typing, name)

    def get_type_hints(self, obj, globalns=None, localns=None,
                       include_extras=False):
        key = (obj, id(globalns), id(localns), include_extras)
        if key not in self._hints:
            self._hints[key] = typing.get_type_hints(obj, globalns, localns,
                                                     include_extras)
        return self._hints[key]


def load_program(blob: bytes) -> torch.export.ExportedProgram:
    """The ``ExportedProgram`` in an artifact."""
    from torch._export.serde import serialize
    if getattr(serialize, "typing", None) is not typing:
        return torch.export.load(io.BytesIO(blob))
    # only the deserializer's module sees the memoised hints, only for
    # this call
    with _LOAD_LOCK:
        serialize.typing = _TypingWithCachedHints()
        try:
            return torch.export.load(io.BytesIO(blob))
        finally:
            serialize.typing = typing


def _program(blob_or_program) -> torch.export.ExportedProgram:
    if isinstance(blob_or_program, (bytes, bytearray)):
        return load_program(blob_or_program)
    return blob_or_program


def load_forward(blob, device=None) -> Callable[[Dict[str, Any]], Any]:
    """Deserialize an artifact (bytes, or the ``ExportedProgram`` that
    :func:`load_program` gave) into ``fn(batch)``.

    With ``device`` (e.g. ``"cuda"``), the program's weights, constants and
    device arguments move there first (``move_to_device_pass``).  ``fn``
    takes the batch dict (``_meta`` and non-tensor keys dropped) with the
    exported shapes and dtypes and runs without autograd."""
    program = _program(blob)
    if device is not None:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, str(torch.device(device)))
    module = program.module()

    def fn(batch: Dict[str, Any]):
        with torch.no_grad():
            return module(tensor_batch(batch))
    return fn


def exported_platforms(blob) -> tuple:
    """The device types of the artifact's (or program's) weights and
    constants, sorted."""
    program = _program(blob)
    tensors = list(program.state_dict.values()) + [
        c for c in program.constants.values()
        if isinstance(c, torch.Tensor)]
    return tuple(sorted({t.device.type for t in tensors}))


def kernel_nodes(blob) -> int:
    """How many ``pq3d::zrun_conv`` nodes (kernel B1) the artifact's (or
    program's) graph holds."""
    return sum(1 for n in _program(blob).graph.nodes
               if n.op == "call_function" and n.target is ZRUN_CONV_OP)


def while_loop_nodes(blob) -> int:
    """How many ``torch.while_loop`` nodes (an early-exit decode keeps
    one) the artifact's (or program's) top-level graph holds."""
    loop = torch.ops.higher_order.while_loop
    return sum(1 for n in _program(blob).graph.nodes
               if n.op == "call_function" and n.target is loop)
