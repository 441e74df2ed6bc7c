"""Import HuggingFace and reference PQ3D torch checkpoints into the port.

Counterpart of ``pq3d_tpu/utils/hf_import.py``.  The reference loads
pretrained HF weights for its CLIP text tower
(openai/clip-vit-large-patch14) and its T5 (t5-small) generation head,
and a PQ3D checkpoint as a non-strict ``state_dict`` load
(trainer/build.py:176-186).  Here:

- ``import_t5_decoder`` and ``import_clip_text_tower`` map an HF
  ``state_dict`` onto the flax-layout parameter tree of the port's
  ``models/t5.T5Decoder`` and ``models/clip_text.CLIPTextTower`` (the JAX
  package's trees, leaf for leaf), which ``utils/weights.
  load_flax_variables`` moves onto the module: T5's shared embedding, its
  relative-attention bias on block 0 only and its RMS norms; CLIP's raw
  ``positional_embedding``, the transposed ``text_projection`` and each
  layer's q, k, v and out projections.
- ``import_query3d`` maps a reference PQ3D ``state_dict`` onto a port
  ``Query3DUnified`` in place: every leaf of the model
  (``utils/weights.flax_leaves``) is resolved by the JAX package's name
  rules, copied here (``_resolve_query3d_leaf``), and written through
  ``utils/weights.torch_name``, so one mapping between the layouts serves
  both this importer and ``load_flax_variables``.  It is non-strict and
  returns the JAX importer's report, every path spelled as the JAX
  package's flax path.

Inputs are ``dict[str, tensor or array]``; tensors are read on the host in
f32.  This module imports numpy and torch only.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pq3d_tpu_torch.utils.weights import flax_leaves, torch_name


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.numpy()
    return np.asarray(x)


def import_t5_decoder(sd: Dict[str, Any], num_layers: int) -> Dict:
    """HF T5ForConditionalGeneration state_dict -> the flax-layout params
    of ``models/t5.T5Decoder`` (decoder side + shared embedding)."""
    p: Dict[str, Any] = {"embed": {"embedding": _np(sd["shared.weight"])}}
    for i in range(num_layers):
        base = f"decoder.block.{i}.layer"

        def proj(part, name):
            return {"kernel": _np(sd[f"{base}.{part}.{name}.weight"]).T}
        blk: Dict[str, Any] = {"self_attn": {
            n: proj("0.SelfAttention", n) for n in "qkvo"}}
        if i == 0:
            blk["self_attn"]["relative_attention_bias"] = {
                "embedding": _np(sd[f"{base}.0.SelfAttention."
                                    "relative_attention_bias.weight"])}
        blk["ln_self"] = {"weight": _np(sd[f"{base}.0.layer_norm.weight"])}
        blk["cross_attn"] = {n: proj("1.EncDecAttention", n) for n in "qkvo"}
        blk["ln_cross"] = {"weight": _np(sd[f"{base}.1.layer_norm.weight"])}
        blk["wi"] = proj("2.DenseReluDense", "wi")
        blk["wo"] = proj("2.DenseReluDense", "wo")
        blk["ln_ff"] = {"weight": _np(sd[f"{base}.2.layer_norm.weight"])}
        p[f"block{i}"] = blk
    p["ln_final"] = {"weight": _np(sd["decoder.final_layer_norm.weight"])}
    return p


def import_clip_text_tower(sd: Dict[str, Any], num_layers: int) -> Dict:
    """HF CLIPTextModelWithProjection state_dict -> the flax-layout params
    of ``models/clip_text.CLIPTextTower``."""
    def lin(prefix):
        return {"kernel": _np(sd[f"{prefix}.weight"]).T,
                "bias": _np(sd[f"{prefix}.bias"])}

    def ln(prefix):
        return {"scale": _np(sd[f"{prefix}.weight"]),
                "bias": _np(sd[f"{prefix}.bias"])}

    p: Dict[str, Any] = {
        "token_embedding": {"embedding": _np(
            sd["text_model.embeddings.token_embedding.weight"])},
        "positional_embedding": _np(
            sd["text_model.embeddings.position_embedding.weight"]),
        "ln_final": ln("text_model.final_layer_norm"),
        "text_projection": _np(sd["text_projection.weight"]).T,
    }
    for i in range(num_layers):
        base = f"text_model.encoder.layers.{i}"
        p[f"block{i}"] = {
            "attn": {n: lin(f"{base}.self_attn.{n}")
                     for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "ln_1": ln(f"{base}.layer_norm1"),
            "ln_2": ln(f"{base}.layer_norm2"),
            "fc1": lin(f"{base}.mlp.fc1"),
            "fc2": lin(f"{base}.mlp.fc2"),
        }
    return p


# ---------------------------------------------------------------------------
# reference PQ3D checkpoints -> Query3DUnified (the JAX package's rules)
# ---------------------------------------------------------------------------

_QKV = {"q": 0, "k": 1, "v": 2}


def _split_in_proj(sd, base: str, part: str) -> np.ndarray:
    """nn.MultiheadAttention's packed ``in_proj_weight`` (rows [q; k; v])
    -> the q, k or v rows."""
    w = _np(sd[f"{base}.in_proj_weight"])
    d = w.shape[0] // 3
    i = _QKV[part]
    return w[i * d:(i + 1) * d]


def _resolve_query3d_leaf(path: str, collection: str,
                          memories: Sequence[str]
                          ) -> Optional[Callable[[Any], np.ndarray]]:
    """flax path -> a function of the state_dict giving the leaf's value in
    the flax layout, or None.  The reference's names, as the JAX package
    cites them: the unified encoder (query_encoder.py:96-181), spatial
    attention (transformers.py:158-240), the mask, ground and QA heads,
    the object encoders (object_encoder.py:34), the voxel seg-level encoder
    (pcd_mask3d_encoder.py:115-154) and its Res16UNet34C (res16unet.py,
    MinkowskiEngine kernels (K, Cin, Cout) in kernel_offsets order),
    PointNet++ (pointnet2_modules.py, pytorch_utils.py), the location
    encoders (query3d_unified.py:63-71); the HF towers are
    ``import_query3d``'s."""
    p = path

    def lin(tbase):
        if p.endswith("/kernel"):
            return lambda sd: _np(sd[f"{tbase}.weight"]).T
        return lambda sd: _np(sd[f"{tbase}.bias"])

    def ln(tbase):
        if p.endswith("/scale") or p.endswith("/weight"):
            return lambda sd: _np(sd[f"{tbase}.weight"])
        return lambda sd: _np(sd[f"{tbase}.bias"])

    def bn(tbase):
        if collection == "batch_stats":
            stat = "running_mean" if p.endswith("/mean") else "running_var"
            return lambda sd: _np(sd[f"{tbase}.{stat}"])
        return ln(tbase)

    def packed(a, part, kind):
        """q/k/v of a packed in-projection ``a``."""
        if kind == "kernel":
            return lambda sd: _split_in_proj(sd, a, part).T
        return lambda sd: np.split(_np(sd[f"{a}.in_proj_bias"]),
                                   3)[_QKV[part]]

    # ---- unified encoder ----------------------------------------------
    m = re.match(r"unified_encoder/layer(\d+)/(.*)", p)
    if m:
        i, rest = int(m.group(1)), m.group(2)
        t = f"unified_encoder.unified_encoder.{i}"
        mm = re.match(r"cross_attns_(\w+)/(.*)", rest)
        if mm:
            mem, sub = mm.group(1), mm.group(2)
            tb = f"{t}.cross_attn_list.{list(memories).index(mem)}"
            if sub.startswith("LayerNorm_0/"):
                return ln(f"{tb}.norm")
            a = f"{tb}.multihead_attn"
            mq = re.match(r"MultiHeadAttention_0/(q|k|v)_proj/"
                          r"(kernel|bias)", sub)
            if mq:
                return packed(a, mq.group(1), mq.group(2))
            if "out_proj" in sub:
                return lin(f"{a}.out_proj")
        for flax, ref in (("ffn/Dense_0/", "ffn.linear1"),
                          ("ffn/Dense_1/", "ffn.linear2"),
                          ("gate_proj/", "gate_proj")):
            if rest.startswith(flax):
                return lin(f"{t}.{ref}")
        if rest.startswith("ffn/LayerNorm_0/"):
            return ln(f"{t}.ffn.norm")
        if rest.startswith("self_attn/LayerNorm_0/"):
            return ln(f"{t}.self_attn.norm")
        ms = re.match(r"self_attn/MultiHeadAttentionSpatial_0/(\w+)/"
                      r"(kernel|bias)", rest)
        if ms:
            return lin(f"{t}.self_attn.self_attn.{ms.group(1)}")
        mn = re.match(r"self_attn/MultiHeadAttention_0/(q|k|v|out)_proj/"
                      r"(kernel|bias)", rest)
        if mn:
            a = f"{t}.self_attn.self_attn"
            if mn.group(1) == "out":
                return lin(f"{a}.out_proj")
            return packed(a, mn.group(1), mn.group(2))
        return None

    # ---- heads ----------------------------------------------------------
    for fb, tb in (("mask_head/cls_head", "mask_head.cls_head"),
                   ("ground_head/og3d_head", "ground_head.og3d_head"),
                   ("txt_encoder/projection", "txt_encoder.projection"),
                   ("qa_head/mlp", "qa_head.mlp")):
        if p.startswith(fb + "/"):
            sub = p[len(fb) + 1:]
            if sub.startswith("Dense_0/"):
                return lin(f"{tb}.0")
            if sub.startswith("LayerNorm_0/"):
                return ln(f"{tb}.2")
            if sub.startswith("Dense_1/"):
                return lin(f"{tb}.4")
    m = re.match(r"mask_head/mask_pred_(\d+)/(q_proj|k_proj)/", p)
    if m:
        return lin(f"mask_head.mask_pred_list.{m.group(1)}.{m.group(2)}")

    # ---- object encoders ------------------------------------------------
    m = re.match(r"(mv|pc|voxel)_encoder/(input_feat_proj|LayerNorm_0)/", p)
    if m:
        enc = f"{m.group(1)}_encoder"
        return (lin(f"{enc}.input_feat_proj.0")
                if m.group(2) == "input_feat_proj"
                else ln(f"{enc}.input_feat_proj.1"))
    # PointNet++: a shared MLP is Conv2d(out, in, 1, 1) + BatchNorm2d
    m = re.match(r"pc_encoder/backbone/sa(\d)/mlp/(dense|bn)(\d)/", p)
    if m:
        s, kind, j = int(m.group(1)), m.group(2), int(m.group(3))
        tb = f"pc_encoder.backbone.sa{s + 1}.mlp_module.layer{j}"
        if kind == "dense":
            return lambda sd: _np(sd[f"{tb}.conv.weight"])[:, :, 0, 0].T
        return bn(f"{tb}.normlayer.bn")

    # ---- voxel seg-level encoder ----------------------------------------
    m = re.match(r"voxel_encoder/feat_proj_(\d+)/(Dense_0|LayerNorm_0)/", p)
    if m:
        tb = f"voxel_encoder.feat_proj_list.{m.group(1)}"
        return lin(f"{tb}.0") if m.group(2) == "Dense_0" else ln(f"{tb}.1")
    m = re.match(r"voxel_encoder/backbone/(.*)", p)
    if m:
        return _resolve_unet(m.group(1), bn)

    # ---- location encoders ----------------------------------------------
    for fb, tb in (("coord_dense/", "coord_encoder.0"),
                   ("coord_ln/", "coord_encoder.1"),
                   ("box_dense/", "box_encoder.0"),
                   ("box_ln/", "box_encoder.1"),
                   ("generation_head/input_proj/",
                    "generation_head.input_proj.0"),
                   ("generation_head/LayerNorm_0/",
                    "generation_head.input_proj.1")):
        if p.startswith(fb):
            return ln(tb) if ("ln" in fb.lower() or "LayerNorm" in fb) \
                else lin(tb)
    if p == "coord_encoder/pos_enc/gauss_B":
        return lambda sd: _np(sd["coord_encoder.pos_enc.gauss_B"])
    m = re.match(r"coord_encoder/(Dense_0|LayerNorm_0)/", p)
    if m:
        return (lin("coord_encoder.feat_proj.0") if m.group(1) == "Dense_0"
                else ln("coord_encoder.feat_proj.1"))
    return None


def _resolve_unet(rest: str, bn) -> Optional[Callable[[Any], np.ndarray]]:
    """The Res16UNet34C's leaves under ``voxel_encoder/backbone/``: the ME
    kernels (``conv0p1s1``, ``conv{l}p{pitch}s2``, ``block{n}.{i}.conv1/2``,
    the 1x1 ``downsample.0`` squeezed, ``convtr{k}p{pitch}s2``, ``final``)
    and the batch norms."""
    tb = "voxel_encoder.backbone"
    if rest.startswith("conv0/kernel"):
        return lambda sd: _np(sd[f"{tb}.conv0p1s1.kernel"])
    m = re.match(r"conv(\d)s2/kernel", rest)
    if m:
        lvl = int(m.group(1))
        key = f"{tb}.conv{lvl}p{2 ** (lvl - 1)}s2.kernel"
        return lambda sd: _np(sd[key])
    m = re.match(r"(bn|bntr)(\d)/", rest)
    if m:
        return bn(f"{tb}.{m.group(1)}{m.group(2)}")
    m = re.match(r"convtr(\d)/kernel", rest)
    if m:
        k = int(m.group(1))
        key = f"{tb}.convtr{k}p{2 ** (8 - k)}s2.kernel"
        return lambda sd: _np(sd[key])
    m = re.match(r"stage(\d)/block(\d+)/(conv1|conv2|norm1|norm2|"
                 r"downsample_conv|downsample_norm)/", rest)
    if m:
        blk = f"{tb}.block{m.group(1)}.{m.group(2)}"
        layer = m.group(3)
        if layer in ("conv1", "conv2"):
            return lambda sd: _np(sd[f"{blk}.{layer}.kernel"])
        if layer in ("norm1", "norm2"):
            return bn(f"{blk}.{layer}")
        if layer == "downsample_conv":
            # the ME 1x1 conv kernel (1, Cin, Cout) is the Dense kernel
            return lambda sd: np.squeeze(_np(sd[f"{blk}.downsample.0.kernel"]))
        return bn(f"{blk}.downsample.1")
    if rest.startswith("final/kernel"):
        return lambda sd: np.squeeze(_np(sd[f"{tb}.final.kernel"]))
    if rest.startswith("final/bias"):
        return lambda sd: _np(sd[f"{tb}.final.bias"])
    return None


class _Recording(dict):
    """A state_dict that records every key read (a read of a missing key
    too, as the JAX importer's does)."""

    def __init__(self, *a):
        super().__init__(*a)
        self.used = set()

    def __getitem__(self, key):
        self.used.add(key)
        return dict.__getitem__(self, key)


def canonical_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's key spellings made one: DDP's ``module.`` prefix
    stripped, and the flat ``unified_encoder.layers.{i}`` alias read as
    the ``layer_repeat`` nesting ``unified_encoder.unified_encoder.{i}``."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k.replace("unified_encoder.layers.",
                      "unified_encoder.unified_encoder.")] = v
    return out


def import_query3d(sd: Dict[str, Any], model: torch.nn.Module,
                   memories: Sequence[str] = ("mv", "pc", "voxel", "prompt"),
                   t5_layers: Optional[int] = None,
                   clip_layers: Optional[int] = None,
                   collections: Sequence[str] = ("params", "batch_stats")
                   ) -> Dict[str, list]:
    """Load a reference PQ3D ``state_dict`` into ``model`` (a port
    ``Query3DUnified``) in place, non-strict as the reference's load: the
    leaves of ``collections`` that the name rules resolve and whose shapes
    match are written; the rest keep their values.  ``memories`` is
    ``cfg.model.memories``, the order of ``cross_attn_list.{j}``.  The HF
    towers come from the keys under ``txt_encoder.model.`` (CLIP, at least
    ``clip_layers`` blocks) and ``generation_head.model.`` (T5, at least
    ``t5_layers``).

    Returns the JAX importer's report: ``loaded`` (flax paths),
    ``missing`` (``collection:path`` with no source, the towers' leaves
    left out), ``mismatched`` ((path, flax shape, source shape)) and
    ``unused`` (state_dict keys never read, sorted)."""
    sd = _Recording(canonical_state_dict(sd))
    report: Dict[str, list] = {"loaded": [], "missing": [], "mismatched": []}
    state = dict(model.named_parameters())
    state.update(model.named_buffers())

    def write(path: Tuple[str, ...], value: np.ndarray) -> None:
        name, value = torch_name(model, path, value)
        t = state[name]
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.ascontiguousarray(value)).to(t.dtype))

    leaves = flax_leaves(model)
    for collection in collections:
        for _, path, shape in sorted(
                (leaf for leaf in leaves if leaf[0] == collection),
                key=lambda leaf: leaf[1]):
            key = "/".join(path)
            fn = _resolve_query3d_leaf(key, collection, memories)
            src = None
            if fn is not None:
                try:
                    src = fn(sd)
                except KeyError:
                    src = None
            if src is None:
                if not key.startswith(("txt_encoder/tower",
                                       "generation_head/decoder")):
                    report["missing"].append(f"{collection}:{key}")
            elif tuple(src.shape) == shape:
                write(path, np.asarray(src, np.float32))
                report["loaded"].append(key)
            else:
                report["mismatched"].append((key, shape, tuple(src.shape)))

    # the HF towers, by their own importers
    params: Dict[str, Any] = {}
    for coll, path, shape in leaves:
        if coll == "params":
            node = params
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = shape
    for module, prefix, import_fn, torch_prefix, n_min in (
            ("txt_encoder", "tower", import_clip_text_tower,
             "txt_encoder.model.", clip_layers),
            ("generation_head", "decoder", import_t5_decoder,
             "generation_head.model.", t5_layers)):
        dst = params.get(module, {}).get(prefix)
        if not isinstance(dst, dict):
            continue
        keys = [k for k in sd if k.startswith(torch_prefix)]
        if not keys:
            continue
        sub = {k[len(torch_prefix):]: sd[k] for k in keys}
        n = max(n_min or 0, sum(1 for k in dst if k.startswith("block")))
        try:
            tree = import_fn(sub, n)
        except KeyError:
            continue
        _merge_matching(dst, tree, report, (module, prefix), write)

    report["unused"] = sorted(k for k in sd if k not in sd.used)
    return report


def _merge_matching(dst: Dict, src: Dict, report: Dict[str, list],
                    prefix: Tuple[str, ...], write) -> None:
    """Write the leaves of the tree ``src`` whose paths the model has
    (``dst``: its params' flax shapes, nested) and whose shapes match,
    recording loads and mismatches as the JAX importer does."""
    for k, v in src.items():
        if k not in dst:
            continue
        path = prefix + (k,)
        if isinstance(v, dict) and isinstance(dst[k], dict):
            _merge_matching(dst[k], v, report, path, write)
        elif not isinstance(v, dict):
            want = dst[k] if isinstance(dst[k], tuple) else ()
            if tuple(np.shape(v)) == want:
                write(path, np.asarray(v, np.float32))
                report["loaded"].append("/".join(path))
            else:
                report["mismatched"].append(
                    ("/".join(path), want, tuple(np.shape(v))))
