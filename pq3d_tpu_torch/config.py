"""The slices' configurations as plain dicts (no YAML parser needed).

``INSTSEG_SCENEVERSE`` is ``pq3d_tpu/config/configs/instseg_sceneverse.yaml``
as ``yaml.safe_load`` reads it (``${...}`` interpolations left as
strings); ``INSTSEG_SCENEVERSE_MODEL`` and ``INSTSEG_SCENEVERSE_OPTIONS``
are its ``model`` and ``data.instseg_options`` sections, and
``INSTSEG_SCENEVERSE_GT`` is ``instseg_sceneverse_gt.yaml``, the GT-query
variant, ``INSTSEG_SYNTHETIC`` ``instseg_synthetic.yaml``, the same
model narrowed on synthetic scenes, and ``INSTSEG_SWIN3D_SYNTHETIC``
``instseg_swin3d_synthetic.yaml``, that one with the Swin3D backbone.
The stage-1 slices add one override, ``model.voxel_encoder.args.pallas_conv: true``,
which routes the decoder's 96/128-channel stride-1 3^3 convs to the z-run
CUDA kernel.  ``UNIFIED_TASKS_SCENEVERSE`` and ``UNIFIED_TASKS_SYNTHETIC``
are ``unified_tasks_{sceneverse,synthetic}.yaml``, the stage-2 unified
model, read the same way.  ``load_config`` resolves a named config with
``key=value`` overrides, as the JAX package's loader does for its YAML
files, and ``serving_config`` sets one of the stage-1 serving layouts up.
"""
from __future__ import annotations

import ast
import copy
import re
from typing import Any, Dict, Optional, Sequence

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

INSTSEG_SCENEVERSE: Dict[str, Any] = {
    "name": "instseg-sceneverse",
    "base_dir": "outputs",
    "exp_dir": "",
    "rng_seed": 42,
    "mode": "train",
    "resume": False,
    "pretrain_ckpt_path": "",
    "log_every": 10,
    "debug": {"flag": False, "debug_size": 10},
    "data": {
        "train": ["ScanNetInstSegSceneVerse"],
        "val": ["ScanNetInstSegSceneVerse"],
        "test": ["ScanNetInstSegSceneVerse"],
        "scene_verse_base": None,
        "scene_verse_aux": None,
        "load_scan_options": {
            "load_inst_info": True, "load_pc_info": True,
            "load_segment_info": True, "load_image_segment_feat": False,
            "load_point_segment_feat": False},
        "instseg_options": INSTSEG_SCENEVERSE_OPTIONS,
    },
    "dataloader": {"batchsize": 4, "batchsize_eval": 1, "num_workers": 0},
    "task": "InstSeg",
    "data_wrapper": "InstSegDatasetWrapper",
    "trainer": "Query3DTrainer",
    "solver": {
        "gradient_accumulation_steps": 1,
        "lr": "1e-4",          # a string, as YAML 1.1 reads it
        "grad_norm": 80,
        "epochs": 600,
        "epochs_per_eval": 200,
        "optim": {"name": "AdamW", "args": {"betas": [0.9, 0.98]}},
        "sched": {"name": "warmup_cosine", "args": {"warmup_steps": 0}},
    },
    "eval": {"name": "InstSegEval", "topk_per_scene": 100,
             "use_dbscan": False,
             "ignore_label": "${data.instseg_options.ignore_label}",
             "dataset_name": "ScanNet"},
    "model": INSTSEG_SCENEVERSE_MODEL,
}



def _gt_variant(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """``instseg_sceneverse_gt.yaml`` from ``instseg_sceneverse.yaml``:
    queries at the GT object centres, the GT segment masks as the
    decoder's offline attention masks, the direct criterion, 200 epochs."""
    gt = copy.deepcopy(cfg)
    gt["name"] = "instseg-sceneverse-gt"
    gt["data"]["instseg_options"].update(query_sample_strategy="gt",
                                         offline_mask_source="gt")
    gt["solver"].update(epochs=200, epochs_per_eval=50)
    gt["model"]["use_offline_attn_mask"] = True
    gt["model"]["InstSegLoss"]["criterion_type"] = "direct"
    return gt


INSTSEG_SCENEVERSE_GT: Dict[str, Any] = _gt_variant(INSTSEG_SCENEVERSE)


def _synthetic_variant(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """``instseg_synthetic.yaml`` (the JAX runner's first example) from
    ``instseg_sceneverse.yaml``: the same schema on SyntheticInstSeg
    scenes of 4000 points, hidden 128, 8 heads, one block a layer, batch
    2, 2 epochs."""
    syn = copy.deepcopy(cfg)
    syn.update(name="instseg-synthetic", log_every=5,
               debug={"flag": False, "debug_size": 4})
    data = syn["data"]
    for key in ("scene_verse_base", "scene_verse_aux", "load_scan_options"):
        del data[key]
    data.update(train=["SyntheticInstSeg"], val=["SyntheticInstSeg"],
                test=["SyntheticInstSeg"],
                synthetic={"num_train": 16, "num_val": 4, "n_points": 4000,
                           "n_instances": 8, "n_segments": 64})
    data["instseg_options"] = {
        "num_labels": 200, "ignore_label": -100, "filter_out_classes": [0, 2],
        "voxel_size": 0.05, "num_queries": 120,
        "query_sample_strategy": "fps", "max_segments": 128,
        "max_instances": 32, "voxel_bucket": 2048,
        "stem_mode": "dense_block",
        "level_caps": [4096, 2048, 1024, 512, 256]}
    syn["data"] = {k: data[k] for k in ("train", "val", "test", "synthetic",
                                        "instseg_options")}
    syn["dataloader"] = {"batchsize": 2, "batchsize_eval": 2,
                         "num_workers": 0}
    syn["solver"].update(epochs=2, epochs_per_eval=2)
    syn["eval"] = {"name": "InstSegEval", "topk_per_scene": 100,
                   "ignore_label": "${data.instseg_options.ignore_label}"}
    model = syn["model"]
    model["hidden_size"] = 128
    model["unified_encoder"]["args"].update(num_attention_heads=8,
                                            num_blocks=1)
    return syn


INSTSEG_SYNTHETIC: Dict[str, Any] = _synthetic_variant(INSTSEG_SCENEVERSE)


def _swin_variant(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """``instseg_swin3d_synthetic.yaml`` from ``instseg_synthetic.yaml``:
    the PCDMask3DSwin3DEncoder (the Swin3D window-attention U-Net at its
    defaults), window packs of window 4 and no stem arrays."""
    swin = copy.deepcopy(cfg)
    swin["name"] = "instseg-swin3d-synthetic"
    swin["data"]["instseg_options"].update(swin_window=4, stem_mode="none")
    ve = swin["model"]["voxel_encoder"]
    ve["name"] = "PCDMask3DSwin3DEncoder"
    del ve["args"]["backbone_kwargs"]["config"]["conv1_kernel_size"]
    return swin


INSTSEG_SWIN3D_SYNTHETIC: Dict[str, Any] = _swin_variant(INSTSEG_SYNTHETIC)


def _unified_model(hidden, txt_tower, freeze_pc, n_heads, n_layers,
                   ground_hidden, gen_args):
    """The ``model`` section the two unified YAML files share the form of."""
    def obj_enc(**args):
        return {"name": "ObjectEncoder",
                "args": {**args, "hidden_size": "${model.hidden_size}",
                         "dropout": 0.1, "use_cls_head": False}}
    return {
        "name": "Query3DUnified",
        "memories": ["mv", "pc", "voxel", "prompt"],
        "hidden_size": hidden,
        "use_offline_voxel_fts": True,
        "use_offline_attn_mask": False,
        "skip_query_encoder_mask_pred": True,
        "obj_loc": {"spatial_dim": 5, "dim_loc": 6,
                    "pairwise_rel_type": "center"},
        "txt_encoder": {"name": "CLIPLanguageEncoder",
                        "args": {"use_projection": True,
                                 "projection_type": "mlp",
                                 "num_projection_layers": 1}},
        "txt_tower": txt_tower,
        "mv_encoder": obj_enc(input_feat_size=768, use_projection=True),
        "voxel_encoder": obj_enc(input_feat_size=128, use_projection=True),
        "pc_encoder": obj_enc(backbone="pointnet++",
                              freeze_backbone=freeze_pc),
        "unified_encoder": {
            "name": "QueryMaskEncoder",
            "args": {"hidden_size": "${model.hidden_size}",
                     "num_attention_heads": n_heads, "num_layers": n_layers,
                     "spatial_selfattn": True,
                     "memories": "${model.memories}",
                     "drop_memories_test": [], "memory_dropout": 0.6,
                     "structure": "mixed", "use_self_mask": False,
                     "num_blocks": 1}},
        "heads": ["ground", "generation"],
        "ground_head": {"name": "GroundHead",
                        "args": {"hidden_size": ground_hidden,
                                 "input_size": "${model.hidden_size}",
                                 "dropout": 0.3}},
        "generation_head": {
            "name": "T5",
            "args": {**gen_args, "input_size": "${model.hidden_size}",
                     "use_projection": True},
            "lr": "1e-5"},
        "loss_list": ["ground_loss", "generation_loss"],
        "loss_weights": {"ground_loss": 10},
    }


def _unified_solver(warmup_steps, epochs, epochs_per_eval):
    return {"gradient_accumulation_steps": 1, "lr": "1e-4", "grad_norm": 5.0,
            "optim": {"name": "AdamW", "args": {"betas": [0.9, 0.98]}},
            "sched": {"name": "warmup_cosine",
                      "args": {"warmup_steps": warmup_steps}},
            "epochs": epochs, "epochs_per_eval": epochs_per_eval}


UNIFIED_TASKS_SCENEVERSE: Dict[str, Any] = {
    "name": "unified-sceneverse",
    "base_dir": "outputs",
    "exp_dir": "",
    "rng_seed": 42,
    "mode": "train",
    "resume": False,
    "pretrain_ckpt_path": "",
    "log_every": 50,
    "debug": {"flag": False, "debug_size": 4},
    "data": {
        "scene_verse_base": None,
        "scene_verse_aux": None,
        "scene_verse_pred": None,
        "load_scan_options": {"load_image_obj_feat": True,
                              "load_voxel_obj_feat": True},
        "train": ["ScanReferSceneVerse", "Sr3DSceneVerse", "Nr3DSceneVerse",
                  "Multi3DReferSceneVerse", "ScanQASceneVerse",
                  "SQA3DSceneVerse", "Scan2CapSceneVerse"],
        "val": "${data.train}",
        "test": "${data.train}",
        "Nr3DSceneVerse": {"sr3d_plus_aug": True},
        "unified_options": {"max_obj_len": 80, "num_points": 1024,
                            "prompt_len": 77, "response_len": 50},
    },
    "task": "Query3D",
    "data_wrapper": {"train": "UnifiedTaskDatasetWrapper",
                     "tokenizer": "openai/clip-vit-large-patch14",
                     "generation_tokenizer": "t5-small"},
    "trainer": "MultitaskTrainer",
    "dataloader": {"batchsize": 128, "batchsize_eval": 128,
                   "num_workers": 0},
    "solver": _unified_solver(5000, 50, 10),
    "eval": {"save": False},
    "model": _unified_model(
        768, {"vocab_size": 49408, "width": 768, "layers": 12, "heads": 12},
        freeze_pc=True, n_heads=12, n_layers=4, ground_hidden=384,
        gen_args={"variant": "t5-small", "vocab_size": 32128,
                  "d_model": 512, "d_kv": 64, "d_ff": 2048,
                  "num_layers": 6, "num_heads": 8, "max_new_tokens": 50}),
}

UNIFIED_TASKS_SYNTHETIC: Dict[str, Any] = {
    "name": "unified-synthetic",
    "base_dir": "outputs",
    "exp_dir": "",
    "rng_seed": 42,
    "mode": "train",
    "resume": False,
    "pretrain_ckpt_path": "",
    "log_every": 5,
    "debug": {"flag": False, "debug_size": 4},
    "data": {
        "train": ["SyntheticRefer", "SyntheticQA", "SyntheticCaption"],
        "val": "${data.train}",
        "test": "${data.train}",
        "synthetic": {"num_train": 32, "num_val": 8, "n_points": 3000,
                      "n_instances": 8},
        "unified_options": {"max_obj_len": 32, "num_points": 256,
                            "prompt_len": 16, "response_len": 8},
    },
    "task": "Query3D",
    "data_wrapper": {"train": "UnifiedTaskDatasetWrapper"},
    "trainer": "MultitaskTrainer",
    "dataloader": {"batchsize": 8, "batchsize_eval": 8, "num_workers": 0},
    "solver": _unified_solver(10, 2, 2),
    "eval": {"save": False},
    "model": _unified_model(
        128, {"vocab_size": 64, "width": 64, "layers": 2, "heads": 4},
        freeze_pc=False, n_heads=8, n_layers=2, ground_hidden=64,
        gen_args={"variant": "t5-synthetic", "vocab_size": 64,
                  "d_model": 64, "d_kv": 16, "d_ff": 128, "num_layers": 2,
                  "num_heads": 4, "max_new_tokens": 8}),
}

CONFIGS = {"instseg_sceneverse": INSTSEG_SCENEVERSE,
           "instseg_synthetic": INSTSEG_SYNTHETIC,
           "instseg_swin3d_synthetic": INSTSEG_SWIN3D_SYNTHETIC,
           "instseg_sceneverse_gt": INSTSEG_SCENEVERSE_GT,
           "unified_tasks_sceneverse": UNIFIED_TASKS_SCENEVERSE,
           "unified_tasks_synthetic": UNIFIED_TASKS_SYNTHETIC}

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


def parse_value(text: str) -> Any:
    """A ``key=value`` override's value as YAML reads a scalar or a flow
    list: true/false/null, numbers, Python literals (nested lists of
    numbers among them, e.g. a ``level_cap_ladder``), ``[a, b]`` lists of
    those (bare words become strings), anything else a string."""
    t = text.strip()
    low = t.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none", "~"):
        return None
    if t.startswith("[") and t.endswith("]"):
        try:
            return ast.literal_eval(t)
        except (ValueError, SyntaxError):
            pass
        inner = t[1:-1].strip()
        return [parse_value(v) for v in inner.split(",")] if inner else []
    try:
        return ast.literal_eval(t)
    except (ValueError, SyntaxError):
        return t


def set_dotted(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    """Set ``cfg[a][b][c] = value`` for ``dotted = "a.b.c"``, creating
    missing levels."""
    *path, leaf = dotted.split(".")
    node = cfg
    for part in path:
        node = node.setdefault(part, {})
    node[leaf] = value


def load_config(name: str, overrides: Sequence[str] = ()) -> Dict[str, Any]:
    """The named config with dotted ``key=value`` overrides applied, then
    interpolations resolved."""
    if name.endswith(".yaml"):
        name = name[:-5]
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; known: {sorted(CONFIGS)}")
    raw = copy.deepcopy(CONFIGS[name])
    for ov in overrides:
        key, sep, val = ov.partition("=")
        if not sep:
            raise ValueError(f"override {ov!r} is not key=value")
        set_dotted(raw, key.strip(), parse_value(val))
    return _resolve(raw, raw)


def slice_config() -> Dict[str, Any]:
    """The slices' config, interpolations resolved: instseg_sceneverse
    with the ``pallas_conv: true`` override applied."""
    return load_config("instseg_sceneverse",
                       ["model.voxel_encoder.args.pallas_conv=true"])


# the stage-1 serving layouts (the JAX package's tools/bench_serve.py
# variants) as overrides of instseg_sceneverse: the Res16UNet layouts route
# to the z-run kernel (pallas_conv), the swin ones swap the voxel encoder
# for PCDMask3DSwin3DEncoder at the same widths.  Device-built maps need
# the model's caps to equal the pipeline's: dev_maps' level_caps through
# the interpolation, the flat device layouts' lock (serving_config's
# flat_caps) set on both sides; the Res16UNet ones build the z-run plans
# of levels 1-3 on the device, as the bench's dev_maps variant does
_PALLAS = "model.voxel_encoder.args.pallas_conv=true"
_FLAT = "data.instseg_options.flat_pack=true"
_SWIN = ("model.voxel_encoder.name=PCDMask3DSwin3DEncoder",
         "data.instseg_options.stem_mode='none'",
         "data.instseg_options.swin_window=4", _FLAT)
_DEV_FLAT = ("data.instseg_options.device_maps=true",)
_COMPACT = "data.instseg_options.compact_conv=true"
_NATIVE_INT8 = ("model.voxel_encoder.args.grad_mode=native",
                "model.voxel_encoder.args.int8_gather=true")
_DEV_MAPS = (_PALLAS, "data.instseg_options.device_maps=true",
             "model.voxel_encoder.args.device_maps="
             "${data.instseg_options.level_caps}",
             "model.voxel_encoder.args.device_ztriple=true")
_GATHER = "data.instseg_options.stem_mode=gather"
SERVING_LAYOUTS: Dict[str, Sequence[str]] = {
    "rect": (_PALLAS,),
    "dev_maps": _DEV_MAPS,
    "flat_zt": (_PALLAS, _FLAT, "data.instseg_options.ztriple_conv=true"),
    "flat_swin": _SWIN,
    "dev_flat_swin": _SWIN + _DEV_FLAT,
    "dev_flat_zt": (_PALLAS, _FLAT, *_DEV_FLAT,
                    "model.voxel_encoder.args.device_ztriple=true"),
    # the voxel encoder's remaining conv options (the compact layout runs
    # no kernel B1: JAX switches it off for a batch with compact plans)
    "rect_int8": (_PALLAS, *_NATIVE_INT8),
    "rect_sorted": (_PALLAS, "model.voxel_encoder.args.sorted_gather=true"),
    "flat_compact": (_PALLAS, _FLAT, _COMPACT),
    "flat_compact_int8": (_PALLAS, _FLAT, _COMPACT, *_NATIVE_INT8),
    # the 125-tap gather stem (the JAX pipeline's default stem): nbr5_0
    # built by the host, or on the device beside the other maps
    "rect_gather": (_PALLAS, _GATHER),
    "dev_gather": (*_DEV_MAPS, _GATHER,
                   "model.voxel_encoder.args.device_stem=gather"),
}
# the host layout whose collate_flat derives each device layout's lock
LOCK_PROBE = {"dev_flat_swin": "flat_swin", "dev_flat_zt": "flat_zt"}


def serving_config(layout: str = "rect", overrides: Sequence[str] = (),
                   flat_caps: Optional[Dict[str, int]] = None
                   ) -> Dict[str, Any]:
    """instseg_sceneverse set up to serve ``layout``: ``rect``
    (rectangular, host-built maps), ``dev_maps`` (rectangular, maps and
    z-run plans built on the device: ``voxel_enc.device_maps ==
    level_caps``; the caps must hold every served scene), ``flat_zt`` (the
    flat pack with the z-run gather conv on levels 1-3), ``flat_swin``
    (the flat pack with the Swin3D backbone), or the flat pack with maps
    built on the device, ``dev_flat_swin`` (swin) and ``dev_flat_zt``
    (Res16UNet with the z-run plans built on the device), which need the
    lock ``flat_caps`` (``instseg_pipeline.device_flat_lock`` on the
    ``LOCK_PROBE`` layout's config) as the pipeline's ``flat_shape_caps``
    and the model's ``device_flat_caps``; ``rect_int8`` (``rect`` with
    ``grad_mode: native`` and ``int8_gather``), ``rect_sorted``
    (``sorted_gather``), ``flat_compact`` (the flat pack with
    ``compact_conv``) and ``flat_compact_int8`` (that with ``native`` and
    int8); ``rect_gather`` and ``dev_gather``, ``rect`` and ``dev_maps``
    with the 125-tap gather stem in place of the YAML's dense-block one;
    further ``key=value`` overrides after the layout's."""
    if layout not in SERVING_LAYOUTS:
        raise KeyError(f"unknown serving layout {layout!r}; known: "
                       f"{sorted(SERVING_LAYOUTS)}")
    if (layout in LOCK_PROBE) != (flat_caps is not None):
        raise ValueError(f"layout {layout!r} "
                         + ("needs" if layout in LOCK_PROBE else "takes no")
                         + " flat_caps lock")
    cfg = load_config("instseg_sceneverse",
                      [*SERVING_LAYOUTS[layout], *overrides])
    if flat_caps is not None:
        caps = {k: int(v) for k, v in flat_caps.items()}
        cfg["data"]["instseg_options"]["flat_shape_caps"] = caps
        cfg["model"]["voxel_encoder"]["args"]["device_flat_caps"] = \
            dict(caps)
    return cfg
