"""Experiment runner (CLI); counterpart of ``build_instseg_trainer``,
``build_multitask_trainer`` and ``main`` in ``pq3d_tpu/run.py``:

    python -m pq3d_tpu_torch.run --config-name instseg_sceneverse \\
        data.train=[SyntheticInstSeg] data.val=[SyntheticInstSeg] \\
        solver.epochs=2 device=cpu
    python -m pq3d_tpu_torch.run --config-name unified_tasks_sceneverse \\
        data.train=[SyntheticRefer,SyntheticQA,SyntheticCaption]
    python -m pq3d_tpu_torch.run --config-name instseg_sceneverse_gt \\
        data.scene_verse_base=SCENEVERSE_ROOT

Loads the config, a packaged name (``pq3d_tpu_torch/configs/``) or the path
of a YAML file (``--config-name path/to/exp.yaml``, absolute or relative to
the working directory; ``config.load_config``), applies dotted overrides,
names the experiment dir, snapshots the resolved config as
``config.json``, builds the trainer of the config's ``task`` (``InstSeg``:
stage 1; ``Query3D``: stage 2, the unified tasks) and runs train or test.
``device`` (default ``cuda``) picks where the model runs; ``resume=True``
with ``exp_dir=...`` reloads that dir's snapshot and continues from its
``latest`` checkpoint; otherwise ``pretrain_ckpt_path=...`` warm-starts
the model from another run's checkpoint (stage 2 from stage 1).  The
datasets are the synthetic ones or, with ``data.scene_verse_base``, the
SceneVerse layout's (stage 1: ``ScanNetInstSegSceneVerse``; stage 2: the
seven from ``ScanReferSceneVerse`` to ``Scan2CapSceneVerse``).

Under a process group (``python -m pq3d_tpu_torch.launch``) every rank
runs ``main``: the ``parallel:`` node, ``{data, fsdp, tp,
fsdp_min_size}``, lays the ranks out as a mesh (``parallel/mesh.py``;
``data x fsdp x tp`` must be the world), rank 0 picks the experiment dir
and writes ``config.json``, and each rank trains on the rows of its row
index (the rows split over ``data x fsdp``; tp peers share theirs), with
its parameters sharded where ``fsdp`` or ``tp`` is above 1.  The flat
pack and the flat object layout have no batch dim to split: with more
than one rank it raises unless ``dataloader.allow_single_device`` is set,
and then rank 0 trains alone while the other ranks return; a
``batchsize`` (or ``batchsize_eval``) that ``data x fsdp`` does not
divide takes the same rule.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

from pq3d_tpu_torch.config import apply_overrides, load_config
from pq3d_tpu_torch.parallel import dist
from pq3d_tpu_torch.parallel.mesh import MeshConfig, make_mesh


def _optimizer_total_steps(cfg: Dict[str, Any], steps_per_epoch: int) -> int:
    """The schedule's horizon in optimizer steps: the micro-steps divided
    by ``solver.gradient_accumulation_steps``."""
    from pq3d_tpu_torch.optim.optimizers import accumulation_steps
    return (steps_per_epoch * int(cfg["solver"]["epochs"])
            // accumulation_steps(cfg))


def build_instseg_trainer(cfg: Dict[str, Any]):
    """The stage-1 trainer of a resolved config: datasets and loaders, the
    model (``build_model``), the set loss (or, with ``criterion_type:
    'direct'``, the direct one), the evaluator.  Trains in the rectangular
    layout, the flat pack (``flat_pack``) and with the z-run gather conv
    (``ztriple_conv``), alone or together, with the Res16UNet or the
    Swin3D backbone (whose window must equal the pipeline's
    ``swin_window``), and in the device-map layouts (``device_maps``: the
    model builds the maps from the batch's voxel coordinates; the caps
    must hold every augmented scene, which ``collate`` checks)."""
    from pq3d_tpu_torch.data.datasets import InstSegLoader, build_dataset
    from pq3d_tpu_torch.data.instseg_pipeline import pipeline_config
    from pq3d_tpu_torch.eval.instseg_eval import InstSegEval
    from pq3d_tpu_torch.models.encoders import check_swin_window
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.optim.losses import (InstSegLossConfig,
                                             instseg_direct_loss,
                                             instseg_set_loss)
    from pq3d_tpu_torch.train.trainer import DefaultTrainer, Query3DTrainer

    trainers = {"Query3DTrainer": Query3DTrainer,
                "DefaultTrainer": DefaultTrainer}
    trainer_name = cfg.get("trainer", "Query3DTrainer")
    if trainer_name not in trainers:
        raise NotImplementedError(f"trainer {trainer_name!r} is not ported")
    iopt = cfg["data"]["instseg_options"]
    pipe_cfg = pipeline_config(iopt)
    dl = cfg["dataloader"]
    seed = int(cfg.get("rng_seed", 42))

    def make_loader(split, train):
        ds = build_dataset(cfg, split)
        bs = int(dl["batchsize"] if train
                 else dl.get("batchsize_eval", dl["batchsize"]))
        loader = InstSegLoader(ds, pipe_cfg, bs, train, seed=seed,
                               num_workers=int(dl.get("num_workers", 0)),
                               rank=dist.row_index(), world=dist.rows())
        return loader, len(ds) // bs

    train_loader, steps_per_epoch = make_loader("train", True)
    val_loader, _ = make_loader("val", False)

    device = cfg.get("device", "cuda")
    model = build_model(cfg, device=device, seed=seed)
    check_swin_window(model, pipe_cfg)
    m_loss = cfg["model"].get("InstSegLoss") or {}
    criterion = str(m_loss.get("criterion_type", "set"))
    if criterion not in ("set", "direct"):
        raise NotImplementedError(f"criterion_type {criterion!r} is not "
                                  "'set' or 'direct'")
    matcher = m_loss.get("matcher") or {}
    loss_cfg = InstSegLossConfig(
        cost_class=float(matcher.get("cost_class", 2.0)),
        cost_mask=float(matcher.get("cost_mask", 5.0)),
        cost_dice=float(matcher.get("cost_dice", 2.0)),
        num_classes=int(iopt["num_labels"]),
        ignore_label=int(iopt.get("ignore_label", -100)))

    def loss_fn(out, batch):
        if criterion == "direct":
            # the GT-query variant: query i is instance i, no assignment
            return instseg_direct_loss(out["predictions_class"],
                                       out["predictions_mask"], batch,
                                       ignore_label=loss_cfg.ignore_label)
        return instseg_set_loss(out["predictions_class"],
                                out["predictions_mask"], batch, loss_cfg)

    evaluator = None
    ev = cfg.get("eval") or {}
    if ev.get("name") == "InstSegEval":
        evaluator = InstSegEval(
            use_dbscan=bool(ev.get("use_dbscan", False)),
            topk_per_scene=int(ev.get("topk_per_scene", 100)),
            num_classes=int(iopt["num_labels"]),
            full_resolution=bool(ev.get("full_resolution", True)),
            official_protocol=bool(ev.get("official_protocol", True)),
            min_region_size=float(ev.get("min_region_size", 100.0)))
    return trainers[trainer_name](
        cfg, model, loss_fn, train_loader, val_loader, evaluator,
        total_steps=_optimizer_total_steps(cfg, steps_per_epoch),
        device=device)


def build_multitask_trainer(cfg: Dict[str, Any]):
    """The stage-2 trainer of a resolved config: for each dataset of
    ``data.train`` a train loader (``dataloader.num_workers``) and a val
    loader with the evaluator the dataset names; the train loaders mixed;
    the model (``build_model``); the weighted ``Loss`` of ``loss_list``,
    with ``answer_loss`` added when the heads hold ``qa``.  The pipeline
    reads ``data.unified_options``, ``flat_obj`` and ``flat_obj_bucket``
    included."""
    from pq3d_tpu_torch.data import sceneverse, unified_datasets
    from pq3d_tpu_torch.data.tokenizers import build_tokenizers
    from pq3d_tpu_torch.data.unified_loader import (MixedTaskLoader,
                                                    UnifiedTaskLoader)
    from pq3d_tpu_torch.data.unified_pipeline import UnifiedPipelineConfig
    from pq3d_tpu_torch.eval import caption_eval, grounding_eval, qa_eval
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.optim.loss_aggregator import Loss
    from pq3d_tpu_torch.train.trainer import MultitaskTrainer

    if cfg.get("trainer", "MultitaskTrainer") != "MultitaskTrainer":
        raise NotImplementedError(f"trainer {cfg['trainer']!r} is not ported")
    datasets = {n: getattr(unified_datasets, n) for n in
                ("SyntheticRefer", "SyntheticQA", "SyntheticCaption")}
    sceneverse_names = ("ScanReferSceneVerse", "Sr3DSceneVerse",
                        "Nr3DSceneVerse", "Multi3DReferSceneVerse",
                        "ScanQASceneVerse", "SQA3DSceneVerse",
                        "Scan2CapSceneVerse")
    datasets.update({n: getattr(sceneverse, n) for n in sceneverse_names})
    evaluators = {n: getattr(mod, n) for mod, names in (
        (grounding_eval, ("ScanReferEval", "ReferIt3DEval",
                          "Multi3DReferEval")),
        (qa_eval, ("ScanQAEval", "ScanQAGenEval", "SQA3DEval",
                   "SQA3DGenEval")),
        (caption_eval, ("Scan2CapEval",))) for n in names}
    uo = cfg["data"].get("unified_options") or {}
    pipe_cfg = UnifiedPipelineConfig(
        max_obj_len=int(uo.get("max_obj_len", 80)),
        num_points=int(uo.get("num_points", 1024)),
        prompt_len=int(uo.get("prompt_len", 32)),
        response_len=int(uo.get("response_len", 32)),
        dim_loc=int(cfg["model"]["obj_loc"]["dim_loc"]),
        flat_obj=bool(uo.get("flat_obj", False)),
        flat_obj_bucket=int(uo.get("flat_obj_bucket", 64)))
    seed = int(cfg.get("rng_seed", 42))
    dl = cfg["dataloader"]
    bs = int(dl["batchsize"])
    bs_eval = int(dl.get("batchsize_eval", bs))
    nw = int(dl.get("num_workers", 0))
    save = bool((cfg.get("eval") or {}).get("save"))
    toks = build_tokenizers(cfg)

    def make_ds(ds_name, split):
        # SceneVerse tasks tokenize text; the synthetic ones carry ids
        if ds_name in sceneverse_names:
            return datasets[ds_name](cfg, split, tokenizer=toks.tokenize,
                                     gen_tokenizer=toks.gen_tokenize)
        return datasets[ds_name](cfg, split)

    train_loaders, val_sets = [], []
    steps_per_epoch = 0
    for ds_name in cfg["data"]["train"]:
        if ds_name not in datasets:
            raise NotImplementedError(
                f"dataset {ds_name!r} is not ported; the port trains on "
                f"{sorted(datasets)}")
        train_ds = make_ds(ds_name, "train")
        train_loaders.append(UnifiedTaskLoader(
            train_ds, pipe_cfg, bs, True, seed=seed, num_workers=nw,
            rank=dist.row_index(), world=dist.rows()))
        steps_per_epoch += len(train_ds) // bs
        val_loader = UnifiedTaskLoader(make_ds(ds_name, "val"),
                                       pipe_cfg, bs_eval, False, seed=seed,
                                       rank=dist.row_index(),
                                       world=dist.rows())
        ev_name = train_ds.evaluator
        save_dir = (os.path.join(cfg["exp_dir"], "eval_results", ev_name)
                    if save else None)
        val_sets.append((ds_name, val_loader,
                         evaluators[ev_name](save_dir=save_dir)))

    device = cfg.get("device", "cuda")
    model = build_model(cfg, device=device, seed=seed)
    loss_list = list(cfg["model"].get("loss_list",
                                      ["ground_loss", "generation_loss"]))
    if "qa" in cfg["model"].get("heads", ()) \
            and "answer_loss" not in loss_list:
        loss_list.append("answer_loss")
    loss_fn = Loss(loss_list, cfg["model"].get("loss_weights") or {})
    return MultitaskTrainer(
        cfg, model, loss_fn, MixedTaskLoader(train_loaders, seed=seed),
        val_sets=val_sets, detokenize=toks.detokenize,
        total_steps=_optimizer_total_steps(cfg, steps_per_epoch),
        device=device)


BUILDERS = {"InstSeg": build_instseg_trainer,
            "Query3D": build_multitask_trainer}


def _rget(cfg: Dict[str, Any], dotted: str, default=None):
    """``cfg``'s value at the dotted path, or ``default`` where a part is
    missing or None."""
    node = cfg
    for part in str(dotted).split("."):
        if not hasattr(node, "get"):
            return default
        node = node.get(part)
        if node is None:
            return default
    return node


def experiment_name(cfg: Dict[str, Any]) -> str:
    """The experiment's name from ``naming_keywords``, as the JAX runner
    forms it: the base name, then per keyword ``task`` (the task and
    ``data.note``, else the train sets joined by ``+``), the global batch
    ``b<dataloader.batchsize x world size>`` (JAX multiplies by its device
    count, the port by its ranks), or any other dotted config value;
    ``time`` is skipped; ``Debug_test`` under ``debug.flag``."""
    if _rget(cfg, "debug.flag", False):
        return "Debug_test"
    keys = [str(cfg.get("name", "exp"))]
    for kw in cfg.get("naming_keywords", []) or []:
        kw = str(kw)
        if kw == "time":
            continue
        if kw == "task":
            keys.append(str(cfg.get("task", "")))
            note = _rget(cfg, "data.note")
            if note is not None:
                keys.append(str(note))
            else:
                keys.append("+".join(str(x) for x in
                                     _rget(cfg, "data.train") or []))
        elif kw == "dataloader.batchsize":
            keys.append(f"b{int(_rget(cfg, kw, 0)) * dist.world()}")
        else:
            v = _rget(cfg, kw, "")
            if str(v) != "":
                keys.append(str(v))
    return "_".join(k for k in keys if k)


def single_device_reason(cfg: Dict[str, Any]) -> Optional[str]:
    """Why a run of more than one rank must train on one device (the flat
    pack or the flat object layout, whose arrays have no batch dim to
    split; a batch size the row group, ``data x fsdp``, does not divide),
    or None."""
    data = cfg.get("data") or {}
    iopt = data.get("instseg_options") or {}
    uopt = data.get("unified_options") or {}
    task = cfg.get("task", "InstSeg")
    if task == "InstSeg" and iopt.get("flat_pack"):
        return ("data.instseg_options.flat_pack is a single-device layout "
                "(its flat arrays have no batch dim to split)")
    if task == "Query3D" and uopt.get("flat_obj"):
        return ("data.unified_options.flat_obj is a single-device layout "
                "(its flat arrays have no batch dim to split)")
    dl = cfg["dataloader"]
    for key in ("batchsize", "batchsize_eval"):
        bs = int(dl.get(key, dl["batchsize"]))
        if bs % dist.rows():
            return (f"dataloader.{key}={bs} does not split over "
                    f"{dist.rows()} ranks of rows (parallel.data x fsdp)")
    return None


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser("pq3d_tpu_torch.run")
    parser.add_argument("--config-name", required=True)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    cfg = load_config(args.config_name, overrides=args.overrides)
    # resume re-loads the snapshot saved in the experiment dir so the run
    # continues under the exact original config (overrides re-applied)
    if cfg.get("resume") and cfg.get("exp_dir"):
        snap = os.path.join(str(cfg["exp_dir"]), "config.json")
        if not os.path.exists(snap):
            raise FileNotFoundError(f"Resuming failed: {snap} does not exist")
        print(f"Resuming from {cfg['exp_dir']}")
        with open(snap) as f:
            cfg = apply_overrides(json.load(f), args.overrides)
        cfg["resume"] = True

    mesh = make_mesh(MeshConfig.from_config(cfg))
    if mesh.world > 1:
        print(f"[run] {mesh.describe()}", flush=True)
    reason = single_device_reason(cfg) if dist.world() > 1 else None
    if reason:
        if not (cfg.get("dataloader") or {}).get("allow_single_device"):
            raise ValueError(f"{reason}; unset it or set "
                             f"dataloader.allow_single_device=true to "
                             f"train on one device")
        if dist.rank() > 0:
            print(f"[run] rank {dist.rank()}: {reason}; rank 0 trains "
                  f"alone (dataloader.allow_single_device)")
            dist.destroy_process_group()
            return None
        print(f"[run] {reason}: training on rank 0 alone "
              f"(dataloader.allow_single_device)")
        dist.destroy_process_group()

    if not cfg.get("exp_dir"):
        # one stamp for every rank: rank 0's
        stamp = dist.broadcast_object(time.strftime("%Y-%m-%d-%H%M%S"))
        cfg["exp_dir"] = os.path.join(cfg.get("base_dir", "outputs"),
                                      experiment_name(cfg), stamp)
    os.makedirs(cfg["exp_dir"], exist_ok=True)
    dist.barrier()          # every rank has read a resumed run's snapshot
    if dist.rank() == 0:
        with open(os.path.join(cfg["exp_dir"], "config.json"), "w") as f:
            json.dump(cfg, f, indent=1)

    task = cfg.get("task", "InstSeg")
    if task not in BUILDERS:
        raise NotImplementedError(f"task {task!r} is not ported "
                                  f"({sorted(BUILDERS)})")
    trainer = BUILDERS[task](cfg)
    if cfg.get("mode", "train") == "train":
        trainer.run()
    else:
        trainer.eval_epoch(0)
    return trainer


if __name__ == "__main__":
    main()
