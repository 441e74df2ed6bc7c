"""The slice's configuration as plain dicts (no YAML parser needed).

``INSTSEG_SCENEVERSE_MODEL`` and ``INSTSEG_SCENEVERSE_OPTIONS`` are the
``model`` and ``data.instseg_options`` sections of
``pq3d_tpu/config/configs/instseg_sceneverse.yaml`` as ``yaml.safe_load``
reads them (``${...}`` interpolations left as strings).  The serving slice
adds one override, ``model.voxel_encoder.args.pallas_conv: true``, which
routes the decoder's 96/128-channel stride-1 3^3 convs to the z-run CUDA
kernel.
"""
from __future__ import annotations

import copy
import re
from typing import Any, Dict

INSTSEG_SCENEVERSE_OPTIONS: Dict[str, Any] = {
    "num_labels": 200,
    "ignore_label": -100,
    "filter_out_classes": [0, 2],
    "voxel_size": 0.02,
    "num_queries": 120,
    "query_sample_strategy": "fps",
    "max_segments": 512,
    "max_instances": 120,
    "voxel_bucket": 8192,
    "stem_mode": "dense_block",
    "level_caps": [65536, 32768, 8192, 2048, 512],
}

INSTSEG_SCENEVERSE_MODEL: Dict[str, Any] = {
    "name": "Query3DUnified",
    "memories": ["voxel", "mv", "pc"],
    "hidden_size": 768,
    "use_offline_voxel_fts": False,
    "use_offline_attn_mask": False,
    "obj_loc": {"spatial_dim": 5, "dim_loc": 3,
                "pairwise_rel_type": "center"},
    "voxel_encoder": {
        "name": "PCDMask3DSegLevelEncoder",
        "args": {
            "backbone_kwargs": {
                "config": {"conv1_kernel_size": 5, "bn_momentum": 0.02},
                "in_channels": 3,
                "out_channels": 200,
                "out_fpn": True,
            },
            "freeze_backbone": False,
            "hlevels": [0, 1, 2, 3],
            "hidden_size": "${model.hidden_size}",
            "dropout": 0.1,
        },
    },
    "mv_encoder": {
        "name": "ObjectEncoder",
        "args": {"input_feat_size": 768,
                 "hidden_size": "${model.hidden_size}",
                 "use_projection": True, "use_cls_head": False,
                 "dropout": 0.1},
    },
    "pc_encoder": {
        "name": "ObjectEncoder",
        "args": {"input_feat_size": 768,
                 "hidden_size": "${model.hidden_size}",
                 "use_projection": True, "use_cls_head": False,
                 "dropout": 0.1},
    },
    "unified_encoder": {
        "name": "QueryMaskEncoder",
        "args": {"hidden_size": "${model.hidden_size}",
                 "num_attention_heads": 12, "num_layers": 4,
                 "spatial_selfattn": True, "memories": "${model.memories}",
                 "structure": "parallel", "use_self_mask": True,
                 "num_blocks": 3},
    },
    "heads": ["mask"],
    "mask_head": {
        "name": "MaskHeadSegLevel",
        "args": {"hidden_size": "${model.hidden_size}", "num_targets": 201,
                 "memories_for_match": "${model.memories}",
                 "filter_out_classes":
                     "${data.instseg_options.filter_out_classes}"},
    },
    "loss_list": ["InstSegLoss"],
    "InstSegLoss": {
        "criterion_type": "set",
        "criterion": {"num_classes": "${data.instseg_options.num_labels}",
                      "losses": ["labels", "masks"],
                      "ignore_label": "${data.instseg_options.ignore_label}"},
        "matcher": {"cost_class": 2.0, "cost_mask": 5.0, "cost_dice": 2.0,
                    "ignore_label": "${data.instseg_options.ignore_label}"},
    },
}

_REF = re.compile(r"^\$\{([\w.]+)\}$")


def _resolve(node, root):
    if isinstance(node, dict):
        return {k: _resolve(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v, root) for v in node]
    if isinstance(node, str):
        m = _REF.match(node)
        if m:
            target = root
            for part in m.group(1).split("."):
                target = target[part]
            return _resolve(target, root)
    return node


def slice_config() -> Dict[str, Any]:
    """The serving slice's config, interpolations resolved:
    ``{"model": ..., "data": {"instseg_options": ...}}`` with the
    ``pallas_conv: true`` override applied."""
    model = copy.deepcopy(INSTSEG_SCENEVERSE_MODEL)
    model["voxel_encoder"]["args"]["pallas_conv"] = True
    raw = {"model": model,
           "data": {"instseg_options": copy.deepcopy(
               INSTSEG_SCENEVERSE_OPTIONS)}}
    return _resolve(raw, raw)
