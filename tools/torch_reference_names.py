"""A reference-named PQ3D state_dict built in code from a port model.

The reference's checkpoints (``pytorch_model*.bin``) name their tensors
after the reference's modules; ``pq3d_tpu_torch.utils.hf_import.
import_query3d`` reads them by the JAX package's name rules.  This builds
such a state_dict from a port ``Query3DUnified`` by running those rules
backwards, so that a test or a smoke run can warm-start one model from
another's weights with no file to download:

- the unified encoder's cross and spatial attention with ``in_proj``
  fused (rows [q; k; v]), its FFN and gates, under
  ``unified_encoder.unified_encoder.{i}`` (or the ``layers.{i}`` alias);
- the mask, ground and QA heads' MLPs (``.0``, ``.2``, ``.4``) and the
  mask head's ``mask_pred_list``;
- the object encoders' ``input_feat_proj``, the voxel encoder's
  ``feat_proj_list``, PointNet++'s shared MLPs as ``Conv2d(out, in, 1, 1)``
  and BatchNorm2d;
- the Res16UNet34C in MinkowskiEngine naming: ``conv0p1s1``,
  ``conv{l}p{pitch}s2``, ``block{n}.{i}.conv1/2``, ``downsample.0`` as a
  (1, Cin, Cout) kernel, ``convtr{k}p{pitch}s2``, ``final`` (1, Cin,
  Cout), every batch norm with its running statistics;
- the location encoders.

The HF towers and buffers are not emitted.  ``module_every`` puts DDP's
``module.`` prefix on every n-th key (sorted).  Imports numpy, torch and
the port only.

    sys.path.insert(0, "<checkout>/tools")
    from torch_reference_names import reference_state_dict
    sd = reference_state_dict(model, memories=("voxel", "mv", "pc"))
"""
from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from pq3d_tpu_torch.utils.weights import flax_leaves, torch_name


def flax_value(model: torch.nn.Module, path: Tuple[str, ...],
               shape: Tuple[int, ...]) -> np.ndarray:
    """The leaf at flax ``path`` of ``model`` in the flax layout (f32): a
    Linear's ``kernel`` is its transposed ``weight``."""
    name, _ = torch_name(model, path, np.zeros(shape, np.float32))
    value = model.get_parameter(name) if name in dict(
        model.named_parameters()) else model.get_buffer(name)
    value = value.detach().float().cpu().numpy()
    module = model.get_submodule(".".join(path[:-1]))
    if isinstance(module, torch.nn.Linear) and path[-1] == "kernel":
        return value.T
    return value


def _ln(t: str, leaf: str) -> str:
    return f"{t}.{'weight' if leaf in ('scale', 'weight') else 'bias'}"


def _lin(t: str, leaf: str, v: np.ndarray):
    return (f"{t}.weight", v.T) if leaf == "kernel" else (f"{t}.bias", v)


def _bn(t: str, coll: str, leaf: str) -> str:
    if coll == "batch_stats":
        return f"{t}.{'running_mean' if leaf == 'mean' else 'running_var'}"
    return _ln(t, leaf)


def _unet(rest: str, coll: str, leaf: str, v: np.ndarray):
    tb = "voxel_encoder.backbone"
    if rest == "conv0/kernel":
        return f"{tb}.conv0p1s1.kernel", v
    m = re.fullmatch(r"conv(\d)s2/kernel", rest)
    if m:
        lvl = int(m.group(1))
        return f"{tb}.conv{lvl}p{2 ** (lvl - 1)}s2.kernel", v
    m = re.fullmatch(r"(bn|bntr)(\d)/\w+", rest)
    if m:
        return _bn(f"{tb}.{m.group(1)}{m.group(2)}", coll, leaf), v
    m = re.fullmatch(r"convtr(\d)/kernel", rest)
    if m:
        k = int(m.group(1))
        return f"{tb}.convtr{k}p{2 ** (8 - k)}s2.kernel", v
    m = re.fullmatch(r"stage(\d)/block(\d+)/(\w+)/\w+", rest)
    if m:
        blk = f"{tb}.block{m.group(1)}.{m.group(2)}"
        layer = m.group(3)
        if layer in ("conv1", "conv2"):
            return f"{blk}.{layer}.kernel", v
        if layer in ("norm1", "norm2"):
            return _bn(f"{blk}.{layer}", coll, leaf), v
        if layer == "downsample_conv":
            return f"{blk}.downsample.0.kernel", v[None]
        return _bn(f"{blk}.downsample.1", coll, leaf), v
    if rest == "final/kernel":
        return f"{tb}.final.kernel", v[None]
    if rest == "final/bias":
        return f"{tb}.final.bias", v
    return None


def _reference_key(p: str, coll: str, v: np.ndarray,
                   memories: Sequence[str]):
    """(reference key, value in the reference layout) of one flax leaf;
    ('in_proj', base, part, kind) for a packed projection's part; None
    for a leaf the rules do not name."""
    leaf = p.rsplit("/", 1)[-1]
    m = re.fullmatch(r"unified_encoder/layer(\d+)/(.*)", p)
    if m:
        t = f"unified_encoder.unified_encoder.{m.group(1)}"
        rest = m.group(2)
        mm = re.fullmatch(r"cross_attns_(\w+)/(.*)", rest)
        if mm:
            tb = f"{t}.cross_attn_list.{list(memories).index(mm.group(1))}"
            sub = mm.group(2)
            if sub.startswith("LayerNorm_0/"):
                return _ln(f"{tb}.norm", leaf), v
            mq = re.fullmatch(r"MultiHeadAttention_0/(q|k|v)_proj/\w+", sub)
            if mq:
                return ("in_proj", f"{tb}.multihead_attn", mq.group(1),
                        leaf), v
            return _lin(f"{tb}.multihead_attn.out_proj", leaf, v)
        for flax, ref in (("ffn/Dense_0/", "ffn.linear1"),
                          ("ffn/Dense_1/", "ffn.linear2"),
                          ("gate_proj/", "gate_proj")):
            if rest.startswith(flax):
                return _lin(f"{t}.{ref}", leaf, v)
        if rest.startswith("ffn/LayerNorm_0/"):
            return _ln(f"{t}.ffn.norm", leaf), v
        if rest.startswith("self_attn/LayerNorm_0/"):
            return _ln(f"{t}.self_attn.norm", leaf), v
        ms = re.fullmatch(r"self_attn/MultiHeadAttentionSpatial_0/(\w+)/\w+",
                          rest)
        if ms:
            return _lin(f"{t}.self_attn.self_attn.{ms.group(1)}", leaf, v)
        mn = re.fullmatch(r"self_attn/MultiHeadAttention_0/(q|k|v|out)_proj"
                          r"/\w+", rest)
        if mn:
            a = f"{t}.self_attn.self_attn"
            if mn.group(1) == "out":
                return _lin(f"{a}.out_proj", leaf, v)
            return ("in_proj", a, mn.group(1), leaf), v
        return None
    for fb, tb in (("mask_head/cls_head", "mask_head.cls_head"),
                   ("ground_head/og3d_head", "ground_head.og3d_head"),
                   ("txt_encoder/projection", "txt_encoder.projection"),
                   ("qa_head/mlp", "qa_head.mlp")):
        if p.startswith(fb + "/"):
            sub = p[len(fb) + 1:]
            for flax, idx in (("Dense_0/", 0), ("Dense_1/", 4)):
                if sub.startswith(flax):
                    return _lin(f"{tb}.{idx}", leaf, v)
            if sub.startswith("LayerNorm_0/"):
                return _ln(f"{tb}.2", leaf), v
    m = re.fullmatch(r"mask_head/mask_pred_(\d+)/(q_proj|k_proj)/\w+", p)
    if m:
        return _lin(f"mask_head.mask_pred_list.{m.group(1)}.{m.group(2)}",
                    leaf, v)
    m = re.fullmatch(r"(mv|pc|voxel)_encoder/(input_feat_proj|LayerNorm_0)"
                     r"/\w+", p)
    if m:
        t = f"{m.group(1)}_encoder.input_feat_proj"
        return (_lin(f"{t}.0", leaf, v) if m.group(2) == "input_feat_proj"
                else (_ln(f"{t}.1", leaf), v))
    m = re.fullmatch(r"pc_encoder/backbone/sa(\d)/mlp/(dense|bn)(\d)/\w+", p)
    if m:
        tb = (f"pc_encoder.backbone.sa{int(m.group(1)) + 1}.mlp_module."
              f"layer{m.group(3)}")
        if m.group(2) == "dense":
            return f"{tb}.conv.weight", v.T[:, :, None, None]
        return _bn(f"{tb}.normlayer.bn", coll, leaf), v
    m = re.fullmatch(r"voxel_encoder/feat_proj_(\d+)/(Dense_0|LayerNorm_0)/"
                     r"\w+", p)
    if m:
        tb = f"voxel_encoder.feat_proj_list.{m.group(1)}"
        return (_lin(f"{tb}.0", leaf, v) if m.group(2) == "Dense_0"
                else (_ln(f"{tb}.1", leaf), v))
    m = re.fullmatch(r"voxel_encoder/backbone/(.*)", p)
    if m:
        return _unet(m.group(1), coll, leaf, v)
    for fb, tb in (("coord_dense/", "coord_encoder.0"),
                   ("coord_ln/", "coord_encoder.1"),
                   ("box_dense/", "box_encoder.0"),
                   ("box_ln/", "box_encoder.1"),
                   ("generation_head/input_proj/",
                    "generation_head.input_proj.0"),
                   ("generation_head/LayerNorm_0/",
                    "generation_head.input_proj.1"),
                   ("coord_encoder/Dense_0/", "coord_encoder.feat_proj.0"),
                   ("coord_encoder/LayerNorm_0/",
                    "coord_encoder.feat_proj.1")):
        if p.startswith(fb):
            if "ln" in fb or "LayerNorm" in fb:
                return _ln(tb, leaf), v
            return _lin(tb, leaf, v)
    return None


def reference_state_dict(model: torch.nn.Module, memories: Sequence[str],
                         module_every: int = 0, layers_alias: bool = False,
                         collections: Sequence[str] = ("params",
                                                       "batch_stats")
                         ) -> Dict[str, torch.Tensor]:
    """Every leaf of ``model`` (of ``collections``) that the reference
    names, under its reference name and in its layout, as f32 CPU tensors;
    ``layers_alias`` spells the unified encoder ``unified_encoder.layers``
    and ``module_every`` > 0 prefixes every n-th key with ``module.``."""
    out: Dict[str, np.ndarray] = {}
    packed: Dict[Tuple[str, str], Dict[str, np.ndarray]] = {}
    for coll, path, shape in flax_leaves(model):
        if coll not in collections:
            continue
        ref = _reference_key("/".join(path), coll,
                             flax_value(model, path, shape), memories)
        if ref is None:
            continue
        key, value = ref
        if isinstance(key, tuple):
            _, base, part, kind = key
            packed.setdefault((base, kind), {})[part] = (
                value.T if kind == "kernel" else value)
        else:
            out[key] = value
    for (base, kind), parts in packed.items():
        name = "in_proj_weight" if kind == "kernel" else "in_proj_bias"
        out[f"{base}.{name}"] = np.concatenate([parts[q] for q in "qkv"])
    sd = {}
    for i, key in enumerate(sorted(out)):
        name = key
        if layers_alias:
            name = name.replace("unified_encoder.unified_encoder.",
                                "unified_encoder.layers.")
        if module_every and i % module_every == 0:
            name = "module." + name
        sd[name] = torch.from_numpy(np.ascontiguousarray(out[key],
                                                         np.float32))
    return sd
