"""Move a flax variable tree of the JAX package into the port's modules.

The port's submodules carry the flax module names, so a leaf at
``<collection>/a/b/c/<leaf>`` lands on ``model.get_submodule("a.b.c")``.
Conversions by module type:

- ``nn.Linear``: Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- ``nn.LayerNorm``: ``scale`` -> ``weight`` (eps is set at construction:
  1e-6, the flax default, and 1e-12 in ``MLPHead``);
- ``MaskedBatchNorm``: ``scale``/``bias`` params, ``batch_stats``
  ``mean``/``var`` buffers;
- sparse convs keep their (K, Cin, Cout) layout and tap order;
- ``DenseStemConv``'s kernel keeps the (k^3, Cin, Cout) layout too
  (``ops/sparse.conv0_dense_block`` reshapes it for ``F.conv3d``);
- ``FourierPositionEncoding``: the ``buffers`` collection's ``gauss_B``.

Every leaf is consumed exactly once and every parameter and buffer of the
model is filled; anything left over or missing raises.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(dict(v), prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _target(module: nn.Module, leaf: str, value: np.ndarray
            ) -> Tuple[str, np.ndarray]:
    """(torch attribute name, converted value) for one flax leaf."""
    if isinstance(module, nn.Linear):
        if leaf == "kernel":
            return "weight", value.T
        if leaf == "bias":
            return "bias", value
    elif isinstance(module, nn.LayerNorm):
        if leaf == "scale":
            return "weight", value
        if leaf == "bias":
            return "bias", value
    else:
        return leaf, value
    raise KeyError(f"no counterpart for leaf {leaf!r} on "
                   f"{type(module).__name__}")


def torch_name(model: nn.Module, path: Tuple[str, ...], value: np.ndarray
               ) -> Tuple[str, np.ndarray]:
    """(dotted torch name, converted value) of the flax leaf at ``path``
    (module path + leaf name, without the collection); raises
    ``AttributeError`` or ``KeyError`` when the model has no counterpart."""
    mod_path, leaf = path[:-1], path[-1]
    module = model.get_submodule(".".join(mod_path))
    attr, value = _target(module, leaf, value)
    return ".".join(mod_path + (attr,)), value


def load_flax_variables(model: nn.Module,
                        variables: Dict[str, Dict[str, Any]]) -> None:
    """Fill ``model``'s parameters and buffers from a flax variable tree
    (``{"params", "batch_stats", "buffers"}`` of numpy-convertible arrays).
    Raises ``ValueError`` listing leftover or missing entries."""
    state = dict(model.named_parameters())
    state.update(dict(model.named_buffers()))
    filled = set()
    leftover = []
    for collection, tree in variables.items():
        for path, value in _leaves(tree):
            try:
                name, value = torch_name(model, path, value)
            except (AttributeError, KeyError):
                leftover.append("/".join((collection,) + path))
                continue
            t = state.get(name)
            if t is None or name in filled \
                    or tuple(t.shape) != value.shape:
                leftover.append("/".join((collection,) + path))
                continue
            with torch.no_grad():
                t.copy_(torch.from_numpy(np.array(value))
                        .to(t.dtype))
            filled.add(name)
    missing = sorted(set(state) - filled)
    if leftover or missing:
        raise ValueError(f"flax -> torch weight move is not one-to-one: "
                         f"unconsumed leaves {leftover}, unfilled model "
                         f"entries {missing}")
