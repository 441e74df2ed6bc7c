"""Experiment runner (CLI); counterpart of ``build_instseg_trainer``,
``build_multitask_trainer`` and ``main`` in ``pq3d_tpu/run.py``:

    python -m pq3d_tpu_torch.run --config-name instseg_sceneverse \\
        data.train=[SyntheticInstSeg] data.val=[SyntheticInstSeg] \\
        solver.epochs=2 device=cpu
    python -m pq3d_tpu_torch.run --config-name unified_tasks_sceneverse \\
        data.train=[SyntheticRefer,SyntheticQA,SyntheticCaption]
    python -m pq3d_tpu_torch.run --config-name instseg_sceneverse_gt \\
        data.scene_verse_base=SCENEVERSE_ROOT

Loads the named config dict (``pq3d_tpu_torch/config.py``), applies dotted
overrides, names the experiment dir, snapshots the resolved config as
``config.json``, builds the trainer of the config's ``task`` (``InstSeg``:
stage 1; ``Query3D``: stage 2, the unified tasks) and runs train or test.
``device`` (default ``cuda``) picks where the model runs; ``resume=True``
with ``exp_dir=...`` reloads that dir's snapshot and continues from its
``latest`` checkpoint; otherwise ``pretrain_ckpt_path=...`` warm-starts
the model from another run's checkpoint (stage 2 from stage 1).  The
datasets are the synthetic ones or, with ``data.scene_verse_base``, the
SceneVerse layout's (stage 1: ``ScanNetInstSegSceneVerse``; stage 2: the
seven from ``ScanReferSceneVerse`` to ``Scan2CapSceneVerse``).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

from pq3d_tpu_torch.config import load_config, parse_value, set_dotted


def _optimizer_total_steps(cfg: Dict[str, Any], steps_per_epoch: int) -> int:
    return steps_per_epoch * int(cfg["solver"]["epochs"])


def build_instseg_trainer(cfg: Dict[str, Any]):
    """The stage-1 trainer of a resolved config: datasets and loaders, the
    model (``build_model``), the set loss (or, with ``criterion_type:
    'direct'``, the direct one), the evaluator."""
    from pq3d_tpu_torch.data.datasets import InstSegLoader, build_dataset
    from pq3d_tpu_torch.data.instseg_pipeline import pipeline_config
    from pq3d_tpu_torch.eval.instseg_eval import InstSegEval
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.optim.losses import (InstSegLossConfig,
                                             instseg_direct_loss,
                                             instseg_set_loss)
    from pq3d_tpu_torch.train.trainer import Query3DTrainer

    if cfg.get("trainer", "Query3DTrainer") != "Query3DTrainer":
        raise NotImplementedError(f"trainer {cfg['trainer']!r} is not ported")
    iopt = cfg["data"]["instseg_options"]
    pipe_cfg = pipeline_config(iopt)
    dl = cfg["dataloader"]
    seed = int(cfg.get("rng_seed", 42))

    def make_loader(split, train):
        ds = build_dataset(cfg, split)
        bs = int(dl["batchsize"] if train
                 else dl.get("batchsize_eval", dl["batchsize"]))
        loader = InstSegLoader(ds, pipe_cfg, bs, train, seed=seed,
                               num_workers=int(dl.get("num_workers", 0)))
        return loader, len(ds) // bs

    train_loader, steps_per_epoch = make_loader("train", True)
    val_loader, _ = make_loader("val", False)

    device = cfg.get("device", "cuda")
    model = build_model(cfg, device=device, seed=seed)
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
    return Query3DTrainer(cfg, model, loss_fn, train_loader, val_loader,
                          evaluator,
                          total_steps=_optimizer_total_steps(
                              cfg, steps_per_epoch),
                          device=device)


def build_multitask_trainer(cfg: Dict[str, Any]):
    """The stage-2 trainer of a resolved config: for each dataset of
    ``data.train`` a train loader (``dataloader.num_workers``) and a val
    loader with the evaluator the dataset names; the train loaders mixed;
    the model (``build_model``); the weighted ``Loss`` of ``loss_list``."""
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
    if uo.get("flat_obj"):
        raise NotImplementedError("the flat object layout is not ported")
    pipe_cfg = UnifiedPipelineConfig(
        max_obj_len=int(uo.get("max_obj_len", 80)),
        num_points=int(uo.get("num_points", 1024)),
        prompt_len=int(uo.get("prompt_len", 32)),
        response_len=int(uo.get("response_len", 32)),
        dim_loc=int(cfg["model"]["obj_loc"]["dim_loc"]))
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
        train_loaders.append(UnifiedTaskLoader(train_ds, pipe_cfg, bs, True,
                                               seed=seed, num_workers=nw))
        steps_per_epoch += len(train_ds) // bs
        val_loader = UnifiedTaskLoader(make_ds(ds_name, "val"),
                                       pipe_cfg, bs_eval, False, seed=seed)
        ev_name = train_ds.evaluator
        save_dir = (os.path.join(cfg["exp_dir"], "eval_results", ev_name)
                    if save else None)
        val_sets.append((ds_name, val_loader,
                         evaluators[ev_name](save_dir=save_dir)))

    device = cfg.get("device", "cuda")
    model = build_model(cfg, device=device, seed=seed)
    loss_fn = Loss(list(cfg["model"].get("loss_list",
                                         ["ground_loss", "generation_loss"])),
                   cfg["model"].get("loss_weights") or {})
    return MultitaskTrainer(
        cfg, model, loss_fn, MixedTaskLoader(train_loaders, seed=seed),
        val_sets=val_sets, detokenize=toks.detokenize,
        total_steps=_optimizer_total_steps(cfg, steps_per_epoch),
        device=device)


BUILDERS = {"InstSeg": build_instseg_trainer,
            "Query3D": build_multitask_trainer}


def experiment_name(cfg: Dict[str, Any]) -> str:
    """The config's name (``Debug_test`` under ``debug.flag``); the JAX
    runner's ``naming_keywords`` suffixes are not ported (no port config
    sets them)."""
    if (cfg.get("debug") or {}).get("flag"):
        return "Debug_test"
    if cfg.get("naming_keywords"):
        raise NotImplementedError("naming_keywords are not ported")
    return str(cfg.get("name", "exp"))


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
            cfg = json.load(f)
        for ov in args.overrides:
            key, _, val = ov.partition("=")
            set_dotted(cfg, key.strip(), parse_value(val))
        cfg["resume"] = True

    if not cfg.get("exp_dir"):
        stamp = time.strftime("%Y-%m-%d-%H%M%S")
        cfg["exp_dir"] = os.path.join(cfg.get("base_dir", "outputs"),
                                      experiment_name(cfg), stamp)
    os.makedirs(cfg["exp_dir"], exist_ok=True)
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
