"""Rank program of the port's 2-process data-parallel tests, and the
inputs they share (not a pytest module: it imports torch and the port,
never JAX).

Each rank runs it through the launcher:

    python -m pq3d_tpu_torch.launch --nproc-per-node 2 --devices cpu,cpu \\
        --entry _torch_ddp_worker:main -- CASE DIR

reads its inputs from DIR (written by the test) and writes its results to
``DIR/rank{r}.pt``.  Cases: ``units`` (the synced masked batch norm and
BatchNorm, the loss normalisers, the evaluators' merge, the preemption
flag), ``step1`` / ``step2`` (one train step of the stage-1 / stage-2
model on the rank's rows; ``card_step``: stage 1 on the rank's card), ``resume`` (three runs of ``run.main``: one
cut after its first epoch, its resume, an unbroken one) and
``refusals`` (what ``run.main`` refuses under two ranks, the preemption
agreement and ``allow_single_device``).
"""
import os
import pickle
import sys

import numpy as np
import torch

from pq3d_tpu_torch.data import synthetic
from pq3d_tpu_torch.data import unified_datasets as tds
from pq3d_tpu_torch.data import unified_pipeline as tup
from pq3d_tpu_torch.data.instseg_pipeline import (InstSegPipelineConfig,
                                                  make_batch)
from pq3d_tpu_torch.eval.base import take_rows
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.optim import losses as tlosses
from pq3d_tpu_torch.optim.loss_aggregator import Loss as TLoss
from pq3d_tpu_torch.parallel import dist
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.train.state import make_train_step

torch.set_num_threads(1)
WORLD = 2
CPU = torch.device("cpu")

# ---------------------------------------------------------------- stage 1

def stage1_batch(n_scenes=4, seed=0):
    """A stage-1 batch of ``n_scenes`` small synthetic scenes (host maps,
    the dense-block stem), labels in 3..19."""
    rng = np.random.default_rng(seed)
    pipe = InstSegPipelineConfig(
        voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
        voxel_bucket=128, use_aug=False, stem_mode="dense_block",
        level_caps=[512, 256, 128, 128, 128])
    scenes = [synthetic.make_scene(rng, n_points=n, n_instances=3,
                                   n_segments=16)
              for n in (600, 900, 750, 800, 700, 650)[:n_scenes]]
    b = make_batch(scenes, pipe, rng, train=False)
    b.pop("_meta")
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = rng.standard_normal(
            (n_scenes, 32, 16)).astype(np.float32)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    b["instance_labels"] = (b["instance_labels"] % 17 + 3).astype(np.int32)
    return b


def stage1_model():
    """The stage-1 model of tests/test_torch_trainer.py, dropout 0."""
    return tq3d.Query3DUnified(
        memories=("voxel", "mv", "pc"), heads=("mask",), hidden_size=32,
        dim_loc=3,
        unified=tq3d.UnifiedEncoderCfg(
            num_layers=2, num_blocks=2, num_attention_heads=4,
            structure="parallel", spatial_selfattn=True, use_self_mask=True),
        mv_enc=tq3d.EncoderCfg(16, dropout=0.0),
        pc_enc=tq3d.EncoderCfg(16, dropout=0.0),
        voxel_enc=tq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       dropout=0.0, pallas_conv=True),
        mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)))


def stage1_loss(out, batch):
    return tlosses.instseg_set_loss(
        out["predictions_class"], out["predictions_mask"], batch,
        tlosses.InstSegLossConfig(num_classes=20))


# ---------------------------------------------------------------- stage 2

# the small widths of tests/test_torch_unified_train.py's step, with
# PointNet++ frozen as unified_tasks_sceneverse.yaml freezes it
STAGE2 = ["data.synthetic.n_points=400", "data.synthetic.n_instances=4",
          "data.unified_options.max_obj_len=6",
          "data.unified_options.num_points=32",
          "data.unified_options.prompt_len=8",
          "data.unified_options.response_len=6",
          "model.hidden_size=32", "model.txt_tower.width=16",
          "model.txt_tower.layers=1", "model.txt_tower.heads=2",
          "model.unified_encoder.args.num_attention_heads=4",
          "model.unified_encoder.args.num_layers=1",
          "model.generation_head.args.d_model=16",
          "model.generation_head.args.d_kv=4",
          "model.generation_head.args.d_ff=32",
          "model.generation_head.args.num_layers=1",
          "model.generation_head.args.num_heads=2",
          "model.generation_head.args.max_new_tokens=4",
          "model.ground_head.args.hidden_size=16",
          "model.unified_encoder.args.memory_dropout=0.0",
          "solver.sched.args.warmup_steps=0",
          "model.pc_encoder.args.freeze_backbone=True"]
STAGE2_LOSS = (["ground_loss", "generation_loss"], {"ground_loss": 10})
FEATURE_DIMS = {"mv": 768, "voxel": 128}


def stage2_cfg():
    from pq3d_tpu_torch.config import load_config
    return load_config("unified_tasks_synthetic", STAGE2)


def stage2_batch(cfg, n=6, seed=0):
    """A train-mode batch of ``n`` items cycling through the three
    synthetic datasets."""
    pipe = tup.UnifiedPipelineConfig(
        **{k: cfg["data"]["unified_options"][k] for k in
           ("max_obj_len", "num_points", "prompt_len", "response_len")})
    sets = [getattr(tds, name)(cfg, "train") for name in
            ("SyntheticRefer", "SyntheticQA", "SyntheticCaption")]
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        scene, lang = sets[i % 3].get_item(i // 3)
        item = tup.process_item(scene, lang, pipe, rng, True, FEATURE_DIMS)
        items.append({k: v for k, v in item.items()
                      if not k.startswith("meta_")})
    return tup.collate_unified(items, pipe, FEATURE_DIMS, train=True)


# ------------------------------------------------------------ train step

def plain_f32():
    """Every sparse conv of the port in f32 (the JAX side's
    ``compute_dtype=float32``)."""
    tsparse._round = lambda t, dtype: t.float()


def train_step(model, batch, loss_fn, ddp=None, device=CPU):
    """One train step through ``state.make_train_step`` with SGD at rate 0
    (the parameters stay, the gradients stay readable): the metrics, the
    gradients and the buffers after it (on the host)."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    step = make_train_step(model, opt, sched, loss_fn, ddp=ddp)
    metrics = step(to_device(batch, device))
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.cpu() for n, p in model.named_parameters()
             if p.grad is not None},
            {n: b.cpu() for n, b in model.named_buffers()})


def _ddp(model, device=CPU):
    from torch.nn.parallel import DistributedDataParallel
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=True)


def _rows(batch):
    b = int(batch["query_pad_masks"].shape[0]) // dist.world()
    return take_rows(batch, dist.rank() * b, (dist.rank() + 1) * b)


def case_step1(d):
    plain_f32()
    with open(os.path.join(d, "batch.pkl"), "rb") as f:
        batch = pickle.load(f)
    model = stage1_model()
    model.load_state_dict(torch.load(os.path.join(d, "model.pt")))
    return train_step(model, _rows(batch), stage1_loss, _ddp(model))


def case_card_step(d):
    """``case_step1`` on the rank's card (the launcher's device)."""
    plain_f32()
    dev = torch.device("cuda", torch.cuda.current_device())
    with open(os.path.join(d, "batch.pkl"), "rb") as f:
        batch = pickle.load(f)
    model = stage1_model()
    model.load_state_dict(torch.load(os.path.join(d, "model.pt")))
    model.to(dev)
    return (*train_step(model, _rows(batch), stage1_loss, _ddp(model, dev),
                        dev), torch.distributed.get_backend())


def case_step2(d):
    with open(os.path.join(d, "batch.pkl"), "rb") as f:
        batch = pickle.load(f)
    model = tq3d.build_model(stage2_cfg(), device="cpu")
    model.load_state_dict(torch.load(os.path.join(d, "model.pt")))
    return train_step(model, _rows(batch), TLoss(*STAGE2_LOSS), _ddp(model))


# ------------------------------------------------------------------ units

def bn_inputs(seed=0, b=4, n=40, c=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, c)).astype(np.float32) * 2 + 0.5
    valid = rng.random((b, n)) < 0.7
    valid[:, :3] = True
    r = rng.standard_normal((b, n, c)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, valid, r, scale, bias


def masked_bn(x, valid, r, scale, bias):
    """``MaskedBatchNorm`` (momentum 0.02) in train mode on (B, N, C)
    rows flattened as the U-Net flattens them: its output, the gradients
    of sum(y * r) and the running statistics after it."""
    from pq3d_tpu_torch.models.layers import MaskedBatchNorm
    bn = MaskedBatchNorm(x.shape[-1], momentum=0.02)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.train()
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1])).requires_grad_()
    y = bn(xt, torch.from_numpy(valid.reshape(-1)))
    (y * torch.from_numpy(r.reshape(-1, r.shape[-1]))).sum().backward()
    return {"y": y.detach(), "dx": xt.grad, "dscale": bn.scale.grad,
            "dbias": bn.bias.grad, "mean": bn.mean, "var": bn.var}


def plain_bn(x, r):
    """The unmasked ``BatchNorm`` (PointNet++'s) likewise on (B, N, C)."""
    from pq3d_tpu_torch.models.layers import BatchNorm
    bn = BatchNorm(x.shape[-1])
    bn.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(r)).sum().backward()
    return {"y": y.detach(), "dx": xt.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "mean": bn.running_mean,
            "var": bn.running_var}


def loss_inputs(seed=0, b=4, q=6, s=10, m=4, c=5, t=7, v=11):
    rng = np.random.default_rng(seed)
    n_inst = np.array([1, 3, 0, 2])[:b]
    return {
        "cls": [rng.standard_normal((b, q, c + 1)).astype(np.float32)
                for _ in range(2)],
        "mask": [rng.standard_normal((b, s, q)).astype(np.float32)
                 for _ in range(2)],
        "batch": {"instance_labels": rng.integers(0, c, (b, m)).astype(
                      np.int32),
                  "segment_masks": rng.random((b, m, s)) > 0.6,
                  "instance_valid": np.arange(m)[None] < n_inst[:, None],
                  "seg_pad_masks": np.arange(s)[None] < np.array(
                      [10, 8, 9, 10])[:b, None]},
        "gen_logits": rng.standard_normal((b, t, v)).astype(np.float32),
        "response": rng.integers(0, v, (b, t)).astype(np.int32),
        "response_valid": np.arange(t)[None] < np.array(
            [7, 3, 5, 1])[:b, None],
        "ground_logits": rng.standard_normal((b, m)).astype(np.float32),
        "tgt": (rng.random((b, m)) < 0.3).astype(np.float32),
    }


def losses(inp, lo=0, hi=None):
    """Each loss on rows [lo, hi) of ``inp``: the value (a rank's share
    under a group) and the gradients of its inputs."""
    hi = len(inp["response"]) if hi is None else hi
    cls = [torch.from_numpy(a[lo:hi]).requires_grad_() for a in inp["cls"]]
    msk = [torch.from_numpy(a[lo:hi]).requires_grad_()
           for a in inp["mask"]]
    batch = {k: torch.from_numpy(v[lo:hi]) for k, v in inp["batch"].items()}
    gen = torch.from_numpy(inp["gen_logits"][lo:hi]).requires_grad_()
    grd = torch.from_numpy(inp["ground_logits"][lo:hi]).requires_grad_()
    out = {}
    total, parts = tlosses.instseg_set_loss(
        cls, msk, batch, tlosses.InstSegLossConfig(num_classes=5))
    total.backward()
    out["set"] = (total.item(), {k: v.item() for k, v in parts.items()},
                  [a.grad for a in cls + msk])
    g = tlosses.generation_loss(
        {"generation_logits": gen},
        {"response": torch.from_numpy(inp["response"][lo:hi]),
         "response_valid": torch.from_numpy(inp["response_valid"][lo:hi])})
    g.backward()
    out["generation"] = (g.item(), {}, [gen.grad])
    c = tlosses.ground_loss({"ground_logits": grd},
                            {"tgt_object_id": torch.from_numpy(
                                inp["tgt"][lo:hi])})
    c.backward()
    out["ground"] = (c.item(), {}, [grd.grad])
    return out


def eval_batches(n_items=5, batch=2, seed=0):
    """Global eval batches over ``n_items`` items (the last wrap-padded,
    ``_meta['n_real']``), with each item's model outputs: og3d logits
    (ScanReferEval), stage-1 logits and targets (InstSegEval) and a
    caption (Scan2CapEval); the items' meta lists (the reference caption,
    the corpus key) under ``_meta``, as the stage-2 loader collects
    them."""
    rng = np.random.default_rng(seed)
    q, s, m, c, o = 6, 12, 3, 20, 5
    items = []
    for i in range(n_items):
        tgt = np.zeros(o, np.float32)
        tgt[rng.integers(o)] = 1
        words = rng.choice(["a", "chair", "table", "by", "the", "wall",
                            "red", "big"], size=rng.integers(2, 7))
        items.append({
            "og3d_logits": rng.standard_normal(o).astype(np.float32),
            "tgt_object_id": tgt,
            "predictions_class": rng.standard_normal(
                (q, c + 1)).astype(np.float32),
            "predictions_mask": rng.standard_normal((s, q)).astype(
                np.float32),
            "seg_pad_masks": np.arange(s) < rng.integers(8, s + 1),
            "segment_masks": rng.random((m, s)) < 0.4,
            "instance_labels": rng.integers(3, c, m).astype(np.int32),
            "instance_valid": np.arange(m) < rng.integers(1, m + 1),
            "segment_sizes": rng.integers(20, 200, s).astype(np.float32),
            "caption_pred": " ".join(words[:-1]),
            "caption": " ".join(words[1:]),
            "corpus_key": f"scene{i}|{i % 3}",
        })
    out = []
    for start in range(0, n_items, batch):
        idx = [(start + j) % n_items for j in range(batch)]
        rows = [items[i] for i in idx]
        b = {k: (np.stack([r[k] for r in rows])
                 if isinstance(rows[0][k], np.ndarray)
                 else [r[k] for r in rows]) for k in rows[0]}
        b["query_pad_masks"] = np.ones((batch, q), bool)
        b["_meta"] = {"caption": b.pop("caption"),
                      "corpus_key": b.pop("corpus_key"),
                      "n_real": min(batch, n_items - start)}
        out.append(b)
    return out


def evaluators():
    from pq3d_tpu_torch.eval.caption_eval import Scan2CapEval
    from pq3d_tpu_torch.eval.grounding_eval import ScanReferEval
    from pq3d_tpu_torch.eval.instseg_eval import InstSegEval
    return {"refer": ScanReferEval(), "caption": Scan2CapEval(),
            "instseg": InstSegEval(num_classes=20, topk_per_scene=10)}


def run_evaluators(batches, split=True):
    """Every evaluator over ``batches``, each scoring this rank's real
    rows (all of them in one process), as the trainers feed them: the
    meta lists merged into the batch and cut as per-row lists."""
    from pq3d_tpu_torch.eval.base import (ROW_LISTS, rank_share,
                                          truncate_batch_rows)
    evs = evaluators()
    shares = rank_share(iter(batches), len(batches[0]["query_pad_masks"]),
                        dist.rank(), dist.world()) if split else batches
    for b in shares:
        meta = b["_meta"]
        n_real = meta["n_real"]
        if n_real == 0:
            continue
        rows = len(b["query_pad_masks"])
        b = {k: v for k, v in b.items() if k != "_meta"}
        b.update({k: v for k, v in meta.items() if k != "n_real"})
        b = truncate_batch_rows(b, n_real, rows, ROW_LISTS | set(meta))
        evs["refer"].update({"og3d_logits": b["og3d_logits"]}, b)
        evs["caption"].update({"caption_pred": b["caption_pred"]}, b)
        evs["instseg"].update(
            {"predictions_class": [b["predictions_class"]],
             "predictions_mask": [b["predictions_mask"]]}, b)
    return {k: ev.record() for k, ev in evs.items()}


def accum_inputs(seed=0, micro=4, b=4, c=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((micro, b, c)).astype(np.float32),
            rng.standard_normal((micro, b, 3)).astype(np.float32))


def accumulate(x, y, lo=0, hi=None, ddp=False):
    """Four micro-steps of a small linear model through
    ``make_train_step`` with ``GradientAccumulator(2)`` and SGD (whose
    step scales with the gradient), on rows [lo, hi) of each micro-batch; its loss is the
    rows' share of the mean over every rank's rows.  Returns the weights
    before and after each micro-step."""
    from pq3d_tpu_torch.optim.optimizers import GradientAccumulator

    class Linear(torch.nn.Linear):
        def forward(self, batch):
            return super().forward(batch["x"])
    torch.manual_seed(0)
    model = Linear(x.shape[-1], y.shape[-1])
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)

    def loss_fn(out, batch):
        err = (out - batch["y"]).square().sum()
        return err / tlosses.global_sum(
            torch.tensor(float(out.numel()))), {}
    step = make_train_step(model, opt, sched, loss_fn,
                           accumulator=GradientAccumulator(2),
                           ddp=_ddp(model) if ddp else None)
    out = [[p.detach().clone() for p in model.parameters()]]
    for xb, yb in zip(x, y):
        step({"x": torch.from_numpy(xb[lo:hi]),
              "y": torch.from_numpy(yb[lo:hi])})
        out.append([p.detach().clone() for p in model.parameters()])
    return out


def case_units(d):
    res = {}
    x, valid, r, scale, bias = bn_inputs()
    b = len(x) // dist.world()
    lo, hi = dist.rank() * b, (dist.rank() + 1) * b
    res["masked_bn"] = masked_bn(x[lo:hi], valid[lo:hi], r[lo:hi], scale,
                                 bias)
    res["plain_bn"] = plain_bn(x[lo:hi], r[lo:hi])
    res["losses"] = losses(loss_inputs(), lo, hi)
    res["eval"] = run_evaluators(eval_batches())
    res["accumulate"] = accumulate(*accum_inputs(), lo, hi, ddp=True)
    res["any_rank"] = (dist.any_rank(dist.rank() == 1),
                       dist.any_rank(False))
    res["all_gather"] = dist.all_gather_object(("r", dist.rank()))
    return res


# ------------------------------------------------------ runs of run.main

def _stop_after_first_epoch():
    """The trainers' ``run`` stops after its first epoch, as a job killed
    after its first checkpoint does."""
    from pq3d_tpu_torch.train.trainer import Query3DTrainer
    run = Query3DTrainer.run

    def one_epoch(self):
        self.epochs = 1
        return run(self)
    Query3DTrainer.run = one_epoch
    return lambda: setattr(Query3DTrainer, "run", run)


def _no_signals():
    from pq3d_tpu_torch.train.trainer import Query3DTrainer
    Query3DTrainer.install_preemption_handler = \
        lambda self, signals=None: None


def case_resume(d, argv):
    """``argv``: the stage-1 run's arguments.  Run ``cut`` stops after
    its first epoch and resumes; run ``whole`` goes through; run ``one``,
    cut by the test in one process, resumes in the two ranks."""
    from pq3d_tpu_torch import run
    _no_signals()
    undo = _stop_after_first_epoch()
    first = run.main([*argv, f"exp_dir={d}/cut"])
    undo()
    resumed = run.main(["--config-name", argv[1], "resume=True",
                        f"exp_dir={d}/cut", f"device={CPU}"])
    whole = run.main([*argv, f"exp_dir={d}/whole"])
    # a checkpoint one process saved (by the test) resumed by two ranks
    one = run.main(["--config-name", argv[1], "resume=True",
                    f"exp_dir={d}/one", f"device={CPU}"])
    return {"first_epoch": first.tracker.epoch,
            "steps": (resumed.step, whole.step),
            "from_one": (one.tracker.epoch, one.step, one.world),
            "checksum": dist.param_checksum(whole.model),
            "mini_step": (first._accumulator.mini_step
                          if first._accumulator else None)}


def case_refusals(d, argv):
    """What two ranks refuse, the preemption flag agreed across ranks,
    and ``allow_single_device`` (rank 0 trains alone; last, as it leaves
    the group)."""
    from pq3d_tpu_torch import run
    from pq3d_tpu_torch.train.trainer import Query3DTrainer
    _no_signals()
    res = {}
    for name, extra in (("flat_pack", ["data.instseg_options.flat_pack="
                                       "true"]),
                        ("batchsize", ["dataloader.batchsize=3"]),
                        ("batchsize_eval", ["dataloader.batchsize_eval=1"]),
                        ("tp", ["parallel.tp=3"]),
                        ("data", ["parallel.data=4"])):
        try:
            run.main([*argv, *extra, f"exp_dir={d}/{name}"])
            res[name] = None
        except (ValueError, NotImplementedError) as e:
            res[name] = (type(e).__name__, str(e))

    # rank 1 is signalled during the first step: both ranks stop there
    train_batch = Query3DTrainer.train_batch

    def signalled(self, batch):
        out = train_batch(self, batch)
        if dist.rank() == 1:
            self._preempted = True
        return out
    Query3DTrainer.train_batch = signalled
    try:
        t = run.main([*argv, "solver.epochs=3", f"exp_dir={d}/preempt"])
    finally:
        Query3DTrainer.train_batch = train_batch
    res["preempt"] = (t.step, t.tracker.epoch, t._preempted)

    t = run.main([*argv, "data.instseg_options.flat_pack=true",
                  "dataloader.allow_single_device=true",
                  f"exp_dir={d}/single"])
    res["single"] = None if t is None else (t.step, t.world,
                                            dist.is_initialized())
    return res


def main(argv):
    case, d, rest = argv[0], argv[1], argv[2:]
    run_args = [a for a in rest if not a.startswith("device=")]
    rank = dist.rank()          # before a case leaves the group
    if case in ("resume", "refusals"):
        res = globals()[f"case_{case}"](d, [*run_args, f"device={CPU}"])
    else:
        res = globals()[f"case_{case}"](d)
    torch.save(res, os.path.join(d, f"rank{rank}.pt"))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(case, d, *run_args, devices=("cpu",) * WORLD, backend=None,
          timeout=300):
    """Run ``case`` in one rank per entry of ``devices`` (2 gloo ranks on
    the CPU by default) through the launcher; returns the ranks' results
    (raises with the ranks' output if the launch fails)."""
    import subprocess
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    proc = subprocess.run(
        [sys.executable, "-m", "pq3d_tpu_torch.launch", "--nproc-per-node",
         str(len(devices)), "--devices", ",".join(devices),
         *(["--backend", backend] if backend else []), "--entry",
         "_torch_ddp_worker:main", "--", case, str(d), *run_args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"launch of {case} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    return [torch.load(os.path.join(d, f"rank{r}.pt"), map_location="cpu",
                       weights_only=False) for r in range(len(devices))]


if __name__ == "__main__":
    main(sys.argv[1:])
