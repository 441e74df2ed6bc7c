"""Rank program of the port's mesh tests (``parallel/mesh.py``,
``parallel/tp.py``) and the inputs they share (not a pytest module: it
imports torch and the port, never JAX).

Each rank runs it through the launcher:

    python -m pq3d_tpu_torch.launch --nproc-per-node 4 \\
        --devices cpu,cpu,cpu,cpu --entry _torch_mesh_worker:main -- CASE DIR

reads its inputs from DIR (written by the test) and writes its results to
``DIR/rank{r}.pt``.  Cases: ``forward`` (4 ranks: ``MultiHeadAttention(64,
4)`` and the small unified model in eval mode under ``fsdp=2, tp=2`` and
``data=2, tp=2``), ``step1`` (2 ranks, ``fsdp=2``: one stage-1 train
step), ``step2`` (4 ranks, ``fsdp=2, tp=2``: one stage-2 train step) and
``ckpt`` (4 ranks, ``fsdp=2, tp=2``: ``run.main`` saves a checkpoint, and
resumes one that one process saved).
"""
import os
import sys

import torch

import _torch_ddp_worker as w
from pq3d_tpu_torch.eval.base import take_rows
from pq3d_tpu_torch.models.layers import MultiHeadAttention
from pq3d_tpu_torch.optim.loss_aggregator import Loss as TLoss
from pq3d_tpu_torch.parallel import dist
from pq3d_tpu_torch.parallel.mesh import (MeshConfig, gather_full,
                                          make_mesh, shard_params)
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.train.state import make_train_step

torch.set_num_threads(1)
CPU = torch.device("cpu")
LR = 1e-3
CLIP = 1e-3          # below every step's gradient norm: the clip acts
AXES = {"fsdp2_tp2": dict(fsdp=2, tp=2), "data2_tp2": dict(data=2, tp=2)}


def load(d, name):
    return torch.load(os.path.join(d, name), map_location="cpu",
                      weights_only=False)


def rows(batch, mesh):
    """This rank's rows of a numpy batch: those of its row index."""
    b = int(batch["query_pad_masks"].shape[0]) // mesh.n_rows
    return take_rows(batch, mesh.row_index * b, (mesh.row_index + 1) * b)


def adamw(model):
    return torch.optim.AdamW([p for p in model.parameters()
                              if p.requires_grad], lr=LR, eps=1e-8,
                             weight_decay=0.05)


def train_step(model, batch, loss_fn, sharding=None):
    """One step through ``state.make_train_step`` with AdamW and a clip
    that acts: the metrics, the gradients (after the clip), the weights
    after the update and the state of the parameters each rank holds;
    gathered to full tensors on a mesh."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    opt = adamw(model)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    step = make_train_step(model, opt, sched, loss_fn, grad_norm_max=CLIP,
                           sharding=sharding)
    metrics = {k: float(v) for k, v in step(to_device(batch, CPU)).items()}
    named = [(n, p) for n, p in model.named_parameters()
             if p.grad is not None]
    grads = [p.grad for _, p in named]
    out = {"metrics": metrics}
    if sharding is not None:
        places = [sharding.placement(p) for _, p in named]
        grads = gather_full(sharding.mesh, grads, places)
        out["weights"] = sharding.full_state_dict()
        fsdp = [p for p in sharding.params
                if "fsdp" in sharding.placement(p)]
        full = gather_full(sharding.mesh, [p.data for p in fsdp],
                           [sharding.placement(p) for p in fsdp])
        out["fsdp_bytes"] = (sum(p.nbytes for p in fsdp),
                             sum(t.nbytes for t in full))
        out["replicated_checksum"] = sharding.replicated_checksum()
        out["coords"] = sharding.mesh.coords
    else:
        out["weights"] = model.state_dict()
    out["grads"] = {n: g.detach().clone() for (n, _), g in zip(named, grads)}
    return out


# ------------------------------------------------------------ forward

def unified_model():
    """The port's half of ``tests/test_torch_unified.py``'s small unified
    model (mv, PointNet++ pc, offline voxel and prompt memories; ground
    and generation heads; the mixed decoder)."""
    from pq3d_tpu_torch.models import query3d as tq3d
    return tq3d.Query3DUnified(
        memories=("mv", "pc", "voxel", "prompt"),
        heads=("ground", "generation"), hidden_size=64, dim_loc=6,
        use_offline_voxel_fts=True, mask_head_cfg=None,
        unified=tq3d.UnifiedEncoderCfg(num_layers=1, num_blocks=1,
                                       num_attention_heads=4,
                                       structure="mixed"),
        mv_enc=tq3d.EncoderCfg(32),
        pc_enc=tq3d.EncoderCfg(backbone="pointnet++", freeze_backbone=True),
        voxel_obj_enc=tq3d.EncoderCfg(16),
        ground_head_cfg=tq3d.GroundHeadCfg(hidden_size=32),
        generation_head_cfg=tq3d.GenerationHeadCfg(
            vocab_size=100, d_model=32, d_kv=8, d_ff=64, num_layers=1,
            num_heads=4, max_new_tokens=4),
        txt_cfg=tq3d.TxtEncoderCfg(vocab_size=200, width=32, layers=1,
                                   heads=4))


def case_forward(d):
    """``MultiHeadAttention(64, 4)`` (every parameter fsdp-sharded:
    ``fsdp_min_size`` 1) and the small unified model (``fsdp_min_size``
    64) on this rank's rows, under each mesh of ``AXES``."""
    attn_state = load(d, "mha.pt")
    x = load(d, "mha_x.pt")
    unified_state = load(d, "unified.pt")
    batch = load(d, "unified_batch.pt")
    res = {}
    for name, axes in AXES.items():
        mesh = make_mesh(MeshConfig(**axes, fsdp_min_size=1))
        attn = MultiHeadAttention(64, 4)
        attn.load_state_dict(attn_state)
        sh = shard_params(attn, mesh)
        b = len(x) // mesh.n_rows
        xr = x[mesh.row_index * b:(mesh.row_index + 1) * b]
        with sh.gathered(), torch.no_grad():
            out = attn(xr, xr, xr)
        mesh = make_mesh(MeshConfig(**axes, fsdp_min_size=64))
        model = unified_model()
        model.load_state_dict(unified_state)
        model.eval()
        sh = shard_params(model, mesh)
        modes = sorted({getattr(m, "tp_mode", "") for m in model.modules()
                        if isinstance(m, torch.nn.Linear)} - {""})
        with sh.gathered(), torch.inference_mode():
            got = model(to_device(rows(batch, mesh), CPU))
        res[name] = {"coords": mesh.coords, "row": mesh.row_index,
                     "mha": out, "modes": modes,
                     "ground_logits": got["ground_logits"],
                     "generation_tokens": got["generation_tokens"]}
    return res


# --------------------------------------------------------------- steps

def case_step1(d):
    """One stage-1 step at a global batch of 4 under ``fsdp=2``
    (``fsdp_min_size`` 512: the sparse convs are sharded)."""
    w.plain_f32()
    mesh = make_mesh(MeshConfig(fsdp=2, fsdp_min_size=512))
    model = w.stage1_model()
    model.load_state_dict(load(d, "model.pt"))
    return train_step(model, rows(load(d, "batch.pt"), mesh),
                      w.stage1_loss, shard_params(model, mesh))


def case_step2(d):
    """One stage-2 step at a global batch of 6 under ``fsdp=2, tp=2``
    (``fsdp_min_size`` 512)."""
    from pq3d_tpu_torch.models import query3d as tq3d
    mesh = make_mesh(MeshConfig(fsdp=2, tp=2, fsdp_min_size=512))
    model = tq3d.build_model(w.stage2_cfg(), device="cpu")
    model.load_state_dict(load(d, "model.pt"))
    return train_step(model, rows(load(d, "batch.pt"), mesh),
                      TLoss(*w.STAGE2_LOSS), shard_params(model, mesh))


# ---------------------------------------------------------- checkpoints

def case_ckpt(d, argv):
    """``run.main`` under ``fsdp=2, tp=2``: a run of one epoch (its
    checkpoint, the gathered state it ends with and an evaluation of it),
    then the resume of the checkpoint one process saved in ``d/one`` for
    a second epoch (the gathered state just after the restore, and the
    step the run ends at)."""
    from pq3d_tpu_torch import run
    from pq3d_tpu_torch.train.trainer import Query3DTrainer
    w._no_signals()
    mesh_args = ["parallel.fsdp=2", "parallel.tp=2",
                 "parallel.fsdp_min_size=512"]
    t = run.main([*argv, *mesh_args, f"exp_dir={d}/mesh"])
    res = {"saved": t.sharding.full_state_dict(), "step": t.step,
           "eval": t.eval_epoch(0),
           "coords": t.sharding.mesh.coords,
           "modes": sorted({getattr(m, "tp_mode", "")
                            for m in t.model.modules()} - {""})}
    lazy = Query3DTrainer._lazy_init
    restored = {}

    def record(self):
        # copies: the state dicts share the storage the steps update
        lazy(self)
        restored["model"] = {k: v.clone() for k, v in
                             self.sharding.full_state_dict().items()}
        opt = self.sharding.full_optimizer_state(self._optimizer)
        restored["optimizer"] = {i: {k: v.clone() for k, v in st.items()}
                                 for i, st in opt["state"].items()}
        restored["step"] = self.step
    Query3DTrainer._lazy_init = record
    try:
        t = run.main(["--config-name", argv[1], "resume=True",
                      "solver.epochs=2", f"exp_dir={d}/one",
                      f"device={CPU}", *mesh_args])
    finally:
        Query3DTrainer._lazy_init = lazy
    res["restored"] = restored
    res["resumed_step"] = t.step
    return res


def main(argv):
    case, d, rest = argv[0], argv[1], argv[2:]
    rank = dist.rank()
    if case == "ckpt":
        res = case_ckpt(d, [*rest, f"device={CPU}"])
    else:
        res = globals()[f"case_{case}"](d)
    torch.save(res, os.path.join(d, f"rank{rank}.pt"))


def spawn(case, d, *run_args, n=4, timeout=600):
    """Run ``case`` on ``n`` gloo ranks on the CPU through the launcher;
    returns the ranks' results."""
    import subprocess
    repo = w.REPO
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [repo, os.path.join(repo, "tests")]))
    proc = subprocess.run(
        [sys.executable, "-m", "pq3d_tpu_torch.launch", "--nproc-per-node",
         str(n), "--devices", ",".join(["cpu"] * n), "--entry",
         "_torch_mesh_worker:main", "--", case, str(d), *run_args],
        cwd=repo, env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"launch of {case} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    return [torch.load(os.path.join(d, f"rank{r}.pt"), map_location="cpu",
                       weights_only=False) for r in range(n)]


if __name__ == "__main__":
    main(sys.argv[1:])
