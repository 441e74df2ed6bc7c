"""Move a flax variable tree of the JAX package into the port's modules.

The port's submodules carry the flax module names, so a leaf at
``<collection>/a/b/c/<leaf>`` lands on ``model.get_submodule("a.b.c")``.
Conversions by module type:

- ``nn.Linear``: Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- ``nn.LayerNorm``: ``scale`` -> ``weight`` (eps is set at construction:
  1e-6, the flax default, and 1e-12 in ``MLPHead``);
- ``nn.Embedding``: ``embedding`` -> ``weight``;
- ``BatchNorm`` (flax ``nn.BatchNorm``, PointNet++'s shared MLPs):
  ``scale``/``bias`` -> ``weight``/``bias``, ``batch_stats`` ``mean``/``var``
  -> ``running_mean``/``running_var`` (it keeps no ``num_batches_tracked``);
- ``MaskedBatchNorm``: ``scale``/``bias`` params, ``batch_stats``
  ``mean``/``var`` buffers;
- raw parameters keep their flax names (CLIP's ``positional_embedding``
  and ``text_projection``, ``RMSNorm``'s ``weight``);
- sparse convs keep their (K, Cin, Cout) layout and tap order; the stem
  ``conv0`` keeps the (k^3, Cin, Cout) layout whichever stem runs it
  (``ops/sparse.conv0_dense_block`` reshapes it for ``F.conv3d``);
- ``FourierPositionEncoding``: the ``buffers`` collection's ``gauss_B``;
- the unified model's ``img_encoder``, which flax creates only when the
  init batch carries image prompts, is built first from the tree's
  ``input_feat_proj`` kernel shape (``Query3DUnified.image_encoder``).

The Swin3D backbone (``models/swin3d``) needs no rule of its own either:
its submodules carry the flax names (``stem``, ``down{l}``, ``stage{l}``
/ ``dec{l}`` with ``block{i}``'s ``norm1``, ``attn``, ``norm2``,
``mlp1``, ``mlp2``, ``up{l}``, ``skip{l}``, ``dec0``, ``final`` and each
conv's ``{name}_bn``), ``WindowAttention``'s relative-position table is a
raw parameter that keeps its flax name ``rel_bias`` ((2w-1)^3, heads),
and its ``qkv`` / ``proj`` are ``nn.Linear``.

The decoders need no rule of their own: ``QueryMaskEncoder`` and the
non-mask ``QueryEncoder`` keep the flax names ``layer{i}`` and, in each
layer, ``self_attn``, ``cross_attns_{memory}``, ``ffn`` (``Dense_0``,
``Dense_1``, ``LayerNorm_0``) and ``gate_proj``.

The stage-2 heads and encoders need no rule of their own: ``qa_head``
(``MLPHead_0``), ``GroundHeadV1``'s four ``MLPHead``s, the decoder's
``gate_proj``, the text projection's ``projection{i}``, BERT's
``word_embeddings``, raw ``position_embeddings``, ``layer{i}`` and
``ffn{i}_1`` / ``_2`` / ``_ln``, and the VoteNet modules' ``mlp`` /
``mlp{i}`` keep the flax names.

Every leaf is consumed exactly once and every parameter and buffer of the
model is filled; anything left over or missing raises.  ``flax_leaves``
lists the model's leaves the other way round (collection, flax path,
flax-layout shape), for importers that resolve a checkpoint leaf by leaf
(``utils/hf_import.import_query3d``) and write each through
``torch_name``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from pq3d_tpu_torch.models.layers import BatchNorm, MaskedBatchNorm

_RENAMES = {
    nn.Linear: {"bias": "bias"},
    nn.LayerNorm: {"scale": "weight", "bias": "bias"},
    nn.Embedding: {"embedding": "weight"},
    BatchNorm: {"scale": "weight", "bias": "bias", "mean": "running_mean",
                "var": "running_var"},
}


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
    renames = _RENAMES.get(type(module))
    if renames is None:
        return leaf, value
    if isinstance(module, nn.Linear) and leaf == "kernel":
        return "weight", value.T
    if leaf in renames:
        return renames[leaf], value
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


def flax_leaves(model: nn.Module
                ) -> List[Tuple[str, Tuple[str, ...], Tuple[int, ...]]]:
    """(collection, flax path, flax-layout shape) of every parameter and
    buffer of ``model``, the inverse of ``torch_name``: parameters are
    ``params``, the batch norms' statistics ``batch_stats``, any other
    buffer (the Fourier features' ``gauss_B``) ``buffers``; a Linear's
    ``weight`` is its transposed ``kernel``."""
    out = []
    for mod_name, module in model.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        back = {v: k for k, v in _RENAMES.get(type(module), {}).items()}
        if isinstance(module, nn.Linear):
            back["weight"] = "kernel"
        stats = isinstance(module, (BatchNorm, MaskedBatchNorm))
        for attr, t in module.named_parameters(recurse=False):
            shape = tuple(t.shape)
            if isinstance(module, nn.Linear) and attr == "weight":
                shape = shape[::-1]
            out.append(("params", prefix + (back.get(attr, attr),), shape))
        for attr, t in module.named_buffers(recurse=False):
            out.append(("batch_stats" if stats else "buffers",
                        prefix + (back.get(attr, attr),), tuple(t.shape)))
    return out


def param_paths(model: nn.Module
                ) -> List[Tuple[str, Tuple[str, ...], Tuple[int, ...], bool]]:
    """(dotted torch name, flax path, flax-layout shape, transposed) of
    every parameter of ``model``, in ``named_parameters`` order:
    ``transposed`` marks a Linear's ``weight``, the flax ``kernel`` with
    its dims reversed (``parallel/mesh.py`` places each parameter by the
    JAX package's rules on the flax path and layout)."""
    out = []
    seen = set()
    for mod_name, module in model.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        back = {v: k for k, v in _RENAMES.get(type(module), {}).items()}
        linear = isinstance(module, nn.Linear)
        if linear:
            back["weight"] = "kernel"
        for attr, t in module.named_parameters(recurse=False):
            if id(t) in seen:
                continue
            seen.add(id(t))
            flip = linear and attr == "weight"
            shape = tuple(t.shape)[::-1] if flip else tuple(t.shape)
            out.append((".".join(prefix + (attr,)),
                        prefix + (back.get(attr, attr),), shape, flip))
    return out


def load_flax_variables(model: nn.Module,
                        variables: Dict[str, Dict[str, Any]]) -> None:
    """Fill ``model``'s parameters and buffers from a flax variable tree
    (``{"params", "batch_stats", "buffers"}`` of numpy-convertible arrays).
    Raises ``ValueError`` listing leftover or missing entries."""
    img = dict(variables.get("params") or {}).get("img_encoder")
    if img is not None and hasattr(model, "image_encoder"):
        model.image_encoder(
            np.shape(dict(dict(img)["input_feat_proj"])["kernel"])[0])
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
