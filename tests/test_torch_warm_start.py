"""The stage-1 -> stage-2 warm start (``pretrain_ckpt_path``) against the
JAX package's ``load_pretrain``, and the two-stage recipe end to end.

- A small stage-1 model's weights (instseg_sceneverse at hidden 32) warm
  start a small stage-2 model (unified_tasks_synthetic at hidden 32) in
  both packages, from the same flax variables moved by utils/weights.py:
  the loaded sets are equal through the weight mapping, every value of the
  warm-started model is equal to JAX's, and everything else keeps its
  init.
- The published configs' warm start (instseg_sceneverse -> unified_tasks_
  sceneverse at full width, the models built on the meta device) loads
  the count that chip_smoke.py's recipe phase checks on the card.
- Reference ``.bin`` weights raise (ROADMAP A.3); ``resume`` wins.
- The recipe of tools/dress_rehearsal.py's ``small`` scale through
  ``python -m pq3d_tpu_torch.run`` on the CPU: stage 1, its resume, the
  GT-query variant and the warm-started stage 2, on a replica written by
  ``pq3d_tpu_torch.data.replica``.
"""
import ast
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.config import default_config_dir
from pq3d_tpu.config import load_config as jload
from pq3d_tpu.data import instseg_pipeline as jpipe
from pq3d_tpu.data import synthetic as jsyn
from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu.train.checkpoints import load_pretrain as jload_pretrain
from pq3d_tpu_torch import run as trun
from pq3d_tpu_torch.config import load_config
from pq3d_tpu_torch.data.replica import ReplicaSpec, write_replica
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.optim import losses as tlosses
from pq3d_tpu_torch.train import checkpoints as tckpt
from pq3d_tpu_torch.train.trainer import Query3DTrainer
from pq3d_tpu_torch.utils.weights import load_flax_variables, torch_name
from test_torch_pointnet import random_variables
from test_torch_unified_train import SMALL, _train_batch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE1 = ["model.hidden_size=32",
          "model.unified_encoder.args.num_attention_heads=4",
          "model.unified_encoder.args.num_layers=1",
          "model.unified_encoder.args.num_blocks=1",
          "model.voxel_encoder.args.hlevels=[0]",
          "data.instseg_options.num_queries=8",
          "data.instseg_options.max_segments=32",
          "data.instseg_options.max_instances=8"]


def _stage1_batch():
    rng = np.random.default_rng(0)
    pipe = jpipe.InstSegPipelineConfig(
        voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
        voxel_bucket=128, use_aug=False, stem_mode="dense_block",
        level_caps=[512, 256, 128, 128, 128])
    scenes = [jsyn.make_scene(rng, n_points=600, n_instances=3,
                              n_segments=16) for _ in range(2)]
    b = jpipe.make_batch(scenes, pipe, rng, train=False)
    b.pop("_meta")
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = np.zeros((2, 32, 768), np.float32)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    return jax.tree_util.tree_map(jnp.asarray, b)


def _variables(jm, batch, seed):
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, batch,
        train=False))
    return {c: dict(t) for c, t in random_variables(shapes, seed).items()}


@pytest.fixture(scope="module")
def pair():
    j1 = jload(os.path.join(default_config_dir(), "instseg_sceneverse.yaml"),
               overrides=STAGE1)
    j2 = jload(os.path.join(default_config_dir(),
                            "unified_tasks_synthetic.yaml"), overrides=SMALL)
    t1 = load_config("instseg_sceneverse", STAGE1)
    t2 = load_config("unified_tasks_synthetic", SMALL)
    v1 = _variables(jq3d.build_model(j1), _stage1_batch(), 1)
    b2 = jax.tree_util.tree_map(jnp.asarray, _train_batch(t2))
    v2 = _variables(jq3d.build_model(j2), b2, 2)
    return {"v1": v1, "v2": v2, "t1": t1, "t2": t2}


def _leaves(tree):
    return {tuple(p.key for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_warm_start_matches_jax(pair, tmp_path, capsys):
    v1, v2 = pair["v1"], pair["v2"]
    # JAX: params, then batch_stats, as the trainer's warm start does
    new = {"params": jload_pretrain(v2["params"], v1["params"]),
           "batch_stats": jload_pretrain(v2["batch_stats"],
                                         v1["batch_stats"]),
           "buffers": v2.get("buffers", {})}
    jax_lines = capsys.readouterr().out.strip().splitlines()
    tm2 = tq3d.build_model(pair["t2"], device="cpu")
    jloaded = set()
    for coll in ("params", "batch_stats"):
        old, got = _leaves(v2[coll]), _leaves(new[coll])
        for key, val in got.items():
            if not np.array_equal(val, old[key]):
                jloaded.add(torch_name(tm2, key, val)[0])

    tm1 = tq3d.build_model(pair["t1"], device="cpu")
    load_flax_variables(tm1, v1)
    opt = torch.optim.SGD(tm1.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    tckpt.CheckpointManager(str(tmp_path / "ckpt")).save(
        "latest", tm1, opt, sched, 3, {"epoch": 1})
    load_flax_variables(tm2, v2)
    before = {k: v.clone() for k, v in tm2.state_dict().items()}
    path = tckpt.find_pretrain(str(tmp_path / "ckpt"))
    assert path == str(tmp_path / "ckpt" / "latest" / "state.pt")
    assert tckpt.find_pretrain(str(tmp_path / "ckpt" / "latest")) == path
    assert tckpt.find_pretrain(path) == path
    loaded = tckpt.load_pretrain(tm2, torch.load(
        path, weights_only=False)["model"])
    port_lines = capsys.readouterr().out.strip().splitlines()

    assert len(loaded) == len(set(loaded)) > 20
    assert set(loaded) == jloaded
    # the printed counts of each group are JAX's
    count = [l.split(" (first few")[0] for l in jax_lines]
    assert [l.split(" (first few")[0] for l in port_lines] == count
    assert len(count) == 2
    ref = tq3d.build_model(pair["t2"], device="cpu")
    load_flax_variables(ref, new)
    state, src = tm2.state_dict(), tm1.state_dict()
    for name, t in ref.state_dict().items():
        np.testing.assert_array_equal(state[name].numpy(), t.numpy(),
                                      err_msg=name)
        if name in loaded:
            np.testing.assert_array_equal(state[name].numpy(),
                                          src[name].numpy(), err_msg=name)
        else:
            np.testing.assert_array_equal(state[name].numpy(),
                                          before[name].numpy(),
                                          err_msg=name)


def _meta_model(cfg, monkeypatch):
    monkeypatch.setattr(tq3d, "init_weights", lambda model, gen: None)
    monkeypatch.setattr(tq3d, "resolve_device",
                        lambda device: torch.device("meta"))
    with torch.device("meta"):
        return tq3d.build_model(cfg, device="meta")


def _chip_smoke_constant(name):
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_published_warm_start_count(monkeypatch, capsys):
    """instseg_sceneverse (pallas_conv: true) -> unified_tasks_sceneverse
    at their widths: the count chip_smoke.py's recipe phase must see."""
    s1 = _meta_model(load_config(
        "instseg_sceneverse", ["model.voxel_encoder.args.pallas_conv=true"]),
        monkeypatch)
    s2 = _meta_model(load_config("unified_tasks_sceneverse"), monkeypatch)
    loaded = tckpt.load_pretrain(s2, s1.state_dict())
    capsys.readouterr()
    n_params, n_stats = (len(g) for g in tckpt.warm_start_tensors(s2))
    assert 0 < len(loaded) < n_params + n_stats
    assert len(loaded) == _chip_smoke_constant("RECIPE_WARM_START_LOADED")
    # stage 2 runs no BatchNorm that stage 1 has: PointNet++'s are its own
    assert all(not n.endswith(("running_mean", "running_var"))
               for n in loaded)


def test_reference_bin_weights_raise(tmp_path):
    """Reference weight files are found (a directory's pytorch_model*.bin,
    or the file) beside no port checkpoint, and one that does not hold a
    state_dict raises when read, never loads nothing in silence."""
    (tmp_path / "pytorch_model.bin").write_bytes(b"")
    bin_path = str(tmp_path / "pytorch_model.bin")
    for path in (str(tmp_path), bin_path):
        assert tckpt.find_pretrain(path) is None
        assert tckpt.reference_weights(path) == [bin_path]
        with pytest.raises(EOFError):
            tckpt.load_reference_state_dict(tckpt.reference_weights(path))
    assert tckpt.find_pretrain(str(tmp_path / "absent")) is None
    assert tckpt.reference_weights(str(tmp_path / "absent")) == []


def _metrics(exp, prefix):
    """The last value of every eval metric whose record prefix starts with
    ``prefix`` (tools/dress_rehearsal.py's ``last_metrics``)."""
    out = {}
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if str(rec["prefix"]).startswith(prefix):
                out.update({f"{rec['prefix']}/{k}": v for k, v in
                            rec.items() if k not in ("step", "time",
                                                     "prefix")})
    return out


def _finite(metrics):
    return metrics and all(isinstance(v, (int, float)) and math.isfinite(v)
                           for v in metrics.values())


def test_two_stage_recipe_on_a_replica(tmp_path, monkeypatch):
    # the in-process runs must not leave signal handlers in this process
    monkeypatch.setattr(Query3DTrainer, "install_preemption_handler",
                        lambda self, signals=None: None)
    base, pred, aux = (str(tmp_path / d) for d in ("base", "pred", "aux"))
    write_replica(base, pred, aux, ReplicaSpec(
        n_train=2, n_val=1, n_points=6000, n_objects=8, n_anno_per_scan=4,
        mv_dim=16, voxel_dim=8, seg_dim=16))
    stage1 = [
        "device=cpu", f"data.scene_verse_base={base}",
        f"data.scene_verse_aux={aux}",
        "data.load_scan_options.load_image_segment_feat=true",
        "data.load_scan_options.load_point_segment_feat=true",
        "data.instseg_options.voxel_size=0.05",
        "data.instseg_options.num_queries=16",
        "data.instseg_options.max_segments=128",
        "data.instseg_options.max_instances=16",
        "data.instseg_options.voxel_bucket=256",
        "data.instseg_options.level_caps=null",
        "model.hidden_size=32",
        "model.unified_encoder.args.num_attention_heads=4",
        "model.unified_encoder.args.num_layers=1",
        "model.unified_encoder.args.num_blocks=1",
        "model.voxel_encoder.args.hlevels=[0]",
        "model.mv_encoder.args.input_feat_size=16",
        "model.pc_encoder.args.input_feat_size=16",
        "dataloader.batchsize=2", "dataloader.batchsize_eval=1",
        "eval.save=true", "log_every=1"]
    s1 = str(tmp_path / "stage1")
    t1 = trun.main(["--config-name", "instseg_sceneverse", *stage1,
                    f"exp_dir={s1}", "solver.epochs=1",
                    "solver.epochs_per_eval=1"])
    assert t1.step == 1
    m1 = _metrics(s1, "val")
    assert _finite(m1) and "val/all_ap" in m1

    # the resume: the snapshot's config, one more epoch
    t1b = trun.main(["--config-name", "instseg_sceneverse", f"exp_dir={s1}",
                     "resume=true", "solver.epochs=2",
                     "solver.epochs_per_eval=2"])
    assert t1b.tracker.epoch == 2 and t1b.step == 2
    m1b = _metrics(s1, "val")
    assert _finite(m1b) and not set(m1) - set(m1b)

    # the GT-query variant: offline masks in every batch, direct loss
    direct = []
    orig = tlosses.instseg_direct_loss
    monkeypatch.setattr(tlosses, "instseg_direct_loss",
                        lambda *a, **k: direct.append(1) or orig(*a, **k))
    gt = trun.main(["--config-name", "instseg_sceneverse_gt", *stage1,
                    f"exp_dir={tmp_path / 'gt'}", "solver.epochs=1",
                    "solver.epochs_per_eval=0"])
    batch = next(iter(gt.train_data(0)))
    assert batch["offline_attn_mask"].shape == (2, 16, 128)
    assert gt.model.use_offline_attn_mask
    assert direct == [1]
    with open(os.path.join(tmp_path, "gt", "metrics.jsonl")) as f:
        rec = [json.loads(l) for l in f][-1]
    assert math.isfinite(rec["loss"]) and {
        "loss_ce", "loss_mask", "loss_dice", "loss_ce_0"} <= set(rec)

    # stage 2 over the seven datasets, warm-started from stage 1
    s2 = str(tmp_path / "stage2")
    stage2 = [
        "device=cpu", f"data.scene_verse_base={base}",
        f"data.scene_verse_aux={aux}", f"data.scene_verse_pred={pred}",
        f"exp_dir={s2}", "solver.epochs=1", "solver.epochs_per_eval=1",
        f"pretrain_ckpt_path={os.path.join(s1, 'ckpt', 'latest')}",
        "solver.sched.args.warmup_steps=10",
        "dataloader.batchsize=4", "dataloader.batchsize_eval=4",
        "data.unified_options.max_obj_len=12",
        "data.unified_options.num_points=64",
        "data.unified_options.prompt_len=24",
        "data.unified_options.response_len=12",
        "model.hidden_size=32", "model.unified_encoder.args.num_layers=1",
        "model.unified_encoder.args.num_attention_heads=4",
        "model.txt_tower.width=32", "model.txt_tower.layers=1",
        "model.txt_tower.heads=4", "model.txt_tower.vocab_size=1000",
        "model.mv_encoder.args.input_feat_size=16",
        "model.voxel_encoder.args.input_feat_size=8",
        "model.generation_head.args.d_model=16",
        "model.generation_head.args.num_layers=1",
        "model.generation_head.args.num_heads=2",
        "model.generation_head.args.d_kv=8",
        "model.generation_head.args.d_ff=32",
        "model.generation_head.args.vocab_size=1000",
        "model.generation_head.args.max_new_tokens=4",
        "model.ground_head.args.hidden_size=16"]
    t2 = trun.main(["--config-name", "unified_tasks_sceneverse", *stage2])
    s1_state = torch.load(os.path.join(s1, "ckpt", "latest", "state.pt"),
                          weights_only=False)["model"]
    fresh = tq3d.build_model(load_config("unified_tasks_sceneverse",
                                         stage2), device="cpu")
    expected = tckpt.load_pretrain(fresh, s1_state)
    assert len(t2.warm_started) == len(expected) > 0
    assert set(t2.warm_started) == set(expected)
    m2 = _metrics(s2, "val-")
    assert _finite(m2)
    names = {k.split("/")[0] for k in m2}
    assert names == {f"val-{n}" for n in t2.cfg["data"]["train"]} and \
        len(names) == 7

    # a resume wins over pretrain_ckpt_path
    t2b = trun.main(["--config-name", "unified_tasks_sceneverse",
                     f"exp_dir={s2}", "resume=true", "solver.epochs=1"])
    assert t2b.warm_started == [] and t2b.tracker.epoch == 1
