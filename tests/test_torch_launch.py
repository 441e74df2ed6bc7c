"""The port's launcher (``pq3d_tpu_torch/launch.py``), the process-group
helpers it decodes the environment with (``parallel/dist.py``) and
``ReplicatedServer`` (``serve.py``), on the CPU:

- argument parsing (modes, ``--nproc-per-node``, the refusal of a
  ``device=`` among the runner's arguments), the ``submit`` sbatch text
  against the JAX launcher's (requeue, SIGUSR1 before the kill, ``srun``
  of the ``slurm`` mode with ``resume=True``), torchrun's and SLURM's
  environments;
- no silent fallback: more local ranks than cards without ``--devices``
  raises, ``--devices`` must list every local rank, the backend follows
  the device unless named, a ``parallel`` node whose axes do not make
  the world raises;
- ``python`` mode calls the entry in process; ``--nproc-per-node 2``
  stops the other rank and returns the exit code when one rank fails;
- ``ReplicatedServer`` with two replicas on ``["cpu", "cpu"]`` serves
  every request on both replicas, each scene's logits equal (rel 1e-5) to
  one ``InstSegServer``'s, its answers the same, as
  ``tests/test_serve_mesh.py`` serves JAX's over two devices; without
  devices it refuses a machine with no card.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pq3d_tpu_torch import launch
from pq3d_tpu_torch.data import synthetic
from pq3d_tpu_torch.data.instseg_pipeline import InstSegPipelineConfig
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.parallel import dist
from pq3d_tpu_torch.parallel.mesh import MeshConfig
from pq3d_tpu_torch.serve import InstSegServer, ReplicatedServer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = []


def _record(argv):
    CALLS.append(list(argv))


def test_parse_modes_and_refusals():
    args, run = launch.parse_args(["--nproc-per-node", "2", "--devices",
                                   "cpu,cpu", "--", "--config-name", "x",
                                   "a=1"])
    assert args.mode == "dist" and args.nproc_per_node == 2
    assert run == ["--config-name", "x", "a=1"]
    assert args.entry == "pq3d_tpu_torch.run:main"
    args, run = launch.parse_args(["--", "--config-name", "x"])
    assert args.mode == "python" and run == ["--config-name", "x"]
    with pytest.raises(ValueError, match="--devices"):
        launch.parse_args(["--nproc-per-node", "2", "--", "device=cpu"])
    with pytest.raises(ValueError, match="at least 1"):
        launch.parse_args(["--nproc-per-node", "0"])
    with pytest.raises(ValueError, match="starts no local ranks"):
        launch.parse_args(["--mode", "python", "--nproc-per-node", "2"])


def test_python_mode_calls_the_entry_in_process():
    CALLS.clear()
    assert launch.main(["--entry", "test_torch_launch:_record",
                        "--devices", "cpu", "--", "--config-name",
                        "x"]) == 0
    assert CALLS == [["--config-name", "x", "device=cpu"]]
    assert not dist.is_initialized()


def test_submit_writes_the_requeueing_sbatch(tmp_path):
    path = str(tmp_path / "job.sbatch")
    args, run = launch.parse_args([
        "--mode", "submit", "--nproc-per-node", "4", "--nodes", "2",
        "--partition", "gpu", "--time", "1:00:00", "--backend", "nccl",
        "--sbatch-file", path, "--", "--config-name", "instseg_sceneverse",
        "exp_dir=/x"])
    assert launch.submit_slurm(args, run) == path
    lines = open(path).read().splitlines()
    for want in ("#!/bin/bash", "#SBATCH --nodes=2",
                 "#SBATCH --ntasks-per-node=4", "#SBATCH --gpus-per-node=4",
                 "#SBATCH --requeue", "#SBATCH --open-mode=append",
                 "#SBATCH --signal=USR1@120", "#SBATCH --partition=gpu",
                 "#SBATCH --time=1:00:00"):
        assert want in lines, want
    srun = [ln for ln in lines if ln.startswith("srun ")]
    assert srun == [f"srun {sys.executable} -m pq3d_tpu_torch.launch "
                    f"--mode slurm --backend nccl -- --config-name "
                    f"instseg_sceneverse exp_dir=/x resume=True"]


def test_environment_decoding():
    env = {"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
           "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "10.0.0.1",
           "MASTER_PORT": "29500"}
    assert dist.env_ranks("dist", env) == {
        "rank": 3, "world": 8, "local_rank": 1, "local_world": 2,
        "addr": "10.0.0.1", "port": 29500}
    slurm = {"SLURM_PROCID": "5", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1",
             "SLURM_NTASKS_PER_NODE": "4(x2)", "SLURM_JOB_ID": "123456",
             "SLURM_LAUNCH_NODE_IPADDR": "10.0.0.7"}
    assert dist.env_ranks("slurm", slurm) == {
        "rank": 5, "world": 8, "local_rank": 1, "local_world": 4,
        "addr": "10.0.0.7", "port": 20000 + 123456 % 20000}
    slurm.update(MASTER_ADDR="h0", MASTER_PORT="1234")
    assert dist.env_ranks("slurm", slurm)["addr"] == "h0"
    assert dist.env_ranks("slurm", slurm)["port"] == 1234
    assert dist.env_ranks("dist", {})["rank"] is None
    with pytest.raises(ValueError, match="needs"):
        dist.init_process_group("gloo", None, 2, "127.0.0.1", 1)


def test_devices_and_backends_never_fall_back():
    assert launch.rank_device(1, 2, ["cuda:0", "cuda:0"]) == "cuda:0"
    with pytest.raises(ValueError, match="2 local ranks"):
        launch.rank_device(0, 2, ["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--devices"):
            launch.rank_device(0, 1, None)
    assert launch.default_backend("cuda:1") == "nccl"
    assert launch.default_backend("cpu") == "gloo"
    args, _ = launch.parse_args(["--nproc-per-node", "2", "--devices",
                                 "cuda:0,cuda:0", "--backend", "gloo"])
    assert args.backend == "gloo"
    # the parallel node's axes must make the world (one rank here)
    for node in ({"fsdp": 2}, {"tp": 2}, {"data": 2}):
        with pytest.raises(ValueError, match="does not make the run's 1"):
            MeshConfig.from_config({"parallel": node}).resolve(1)
    assert MeshConfig.from_config({}).resolve(1) == MeshConfig(data=1)


def _fail_rank1(argv):
    """Entry of the failure test: rank 1 fails at once, rank 0 waits."""
    if dist.rank() == 1:
        sys.exit(3)
    time.sleep(120)


def test_a_failing_rank_stops_the_others():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "pq3d_tpu_torch.launch", "--nproc-per-node",
         "2", "--devices", "cpu,cpu", "--entry",
         "test_torch_launch:_fail_rank1", "--", "x"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=100)
    assert proc.returncode == 3, proc.stderr[-3000:]
    assert time.time() - t0 < 60 and "stopped the others" in proc.stderr
    # rank 0 would sleep 120 s: the launcher stopped it


class _Recording(InstSegServer):
    """Keeps each served scene's final logits by the scene's identity."""

    def __init__(self, *a, **k):
        self.logits, self._ids = {}, []
        super().__init__(*a, **k)

    def _dispatch(self, scenes, ids):
        self._ids = [id(s) for s in scenes]
        return super()._dispatch(scenes, ids)

    def _forward(self, batch):
        cls_l, mask_l = super()._forward(batch)
        for i, sid in enumerate(self._ids):
            self.logits[sid] = (cls_l[i].numpy(), mask_l[i].numpy())
        return cls_l, mask_l


def _server(model, device):
    pipe = InstSegPipelineConfig(
        voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
        voxel_bucket=128, use_aug=False, stem_mode="dense_block",
        level_caps=[512, 256, 128, 128, 128])
    return _Recording(model, pipe, batch_size=2, num_classes=20, topk=20,
                      max_delay_s=0.01, extra_features={"mv": 16, "pc": 16},
                      device=device)


def test_replicated_server_matches_one_server():
    rng = np.random.default_rng(3)
    scenes = [synthetic.make_scene(rng, n_points=n, n_instances=3,
                                   n_segments=16)
              for n in (600, 900, 700, 800, 650, 720)]
    for s in scenes:
        s["inst_labels"] = np.minimum(s["inst_labels"], 19)
    model = tq3d.Query3DUnified(
        memories=("voxel", "mv", "pc"), heads=("mask",), hidden_size=32,
        dim_loc=3,
        unified=tq3d.UnifiedEncoderCfg(num_layers=1, num_blocks=1,
                                       num_attention_heads=4,
                                       use_self_mask=True),
        mv_enc=tq3d.EncoderCfg(16), pc_enc=tq3d.EncoderCfg(16),
        voxel_enc=tq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       pallas_conv=True),
        mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)))
    tq3d.init_weights(model, torch.Generator().manual_seed(0))
    model.eval()

    results = {}
    one = _server(model, "cpu")
    try:
        results["one"] = [f.result(timeout=300)
                          for f in [one.submit(s) for s in scenes]]
    finally:
        one.close()
    rep = ReplicatedServer(lambda d: _server(model, d),
                           devices=["cpu", "cpu"])
    try:
        results["rep"] = [f.result(timeout=300)
                          for f in [rep.submit(s) for s in scenes]]
    finally:
        rep.close()
    deadline = time.time() + 30
    while rep.stats_summary()["scenes"] < 6 and time.time() < deadline:
        time.sleep(0.01)
    st = rep.stats_summary()
    assert st["scenes"] == 6 and all(p["scenes"] > 0 for p in st["replicas"])
    assert st["scenes_per_sec"] == sum(p["scenes_per_sec"]
                                       for p in st["replicas"])
    served = {}
    for r in rep.replicas:
        served.update(r.logits)
    for s, a, b in zip(scenes, results["one"], results["rep"]):
        for want, got in zip(one.logits[id(s)], served[id(s)]):
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        assert [p["class"] for p in a] == [p["class"] for p in b]
        np.testing.assert_allclose([p["score"] for p in a],
                                   [p["score"] for p in b], rtol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            ReplicatedServer(lambda d: None)
