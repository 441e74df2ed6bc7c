"""Launcher; counterpart of ``pq3d_tpu/launch.py``.

The JAX package runs one controller per host, which drives every local
chip; torch runs one process (a rank) per card, so this launcher starts
the ranks, joins each to the process group (``parallel/dist.py``) and
calls the runner in each:

    python -m pq3d_tpu_torch.launch --nproc-per-node 4 -- \\
        --config-name instseg_sceneverse \\
        model.voxel_encoder.args.pallas_conv=true
    python -m pq3d_tpu_torch.launch --nproc-per-node 2 --devices cpu,cpu \\
        -- --config-name instseg_synthetic solver.epochs=1
    python -m pq3d_tpu_torch.launch --nproc-per-node 4 -- \\
        --config-name my_exp.yaml         # a YAML file by path

A ``--config-name`` that names an existing file is passed on as an
absolute path (``absolute_config``), so each rank reads the caller's file.

Modes:
  python  -- one process, no process group (the default without
             ``--nproc-per-node``);
  dist    -- this process is one rank: rank, world, address and port from
             the flags or torchrun's environment (``RANK``, ``WORLD_SIZE``,
             ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
  slurm   -- the same from SLURM's (``SLURM_PROCID``, ``SLURM_NTASKS``,
             ``SLURM_LOCALID``; see ``parallel/dist.env_ranks``);
  submit  -- write and ``sbatch`` a requeueing SLURM job (the JAX
             launcher's file: requeue on timeout or preemption, SIGUSR1
             ``--signal-delay-s`` before the kill, on which the trainer
             saves ``latest``; the requeued job resumes), one task per card.

``--nproc-per-node N`` starts N local ranks of one group on this host
(127.0.0.1, a free port), each in ``dist`` mode, waits for them, and
stops them all when one fails.  Rank r runs on ``cuda:{local rank}``; a
local world larger than the cards raises unless ``--devices`` lists each
rank's device (``cpu,cpu`` on the host, or ``cuda:0,cuda:0`` for two
ranks on one card).  The backend is nccl on cards and gloo on the host
unless ``--backend`` names it; nothing switches it behind the caller's
back (nccl refuses two ranks on one card with its own error).  The
launcher passes the device to the runner as ``device=...``; a ``device=``
among the runner's arguments raises.  ``--entry MODULE:FUNCTION`` calls
another function of the runner's arguments in each rank (default
``pq3d_tpu_torch.run:main``).
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

DEFAULT_ENTRY = "pq3d_tpu_torch.run:main"
RANK_WALL_ENV = "PQ3D_RANK_WALL"


def submit_slurm(args, run_args: Sequence[str]) -> str:
    """Write the requeueing sbatch file; returns its path (``sbatch`` is
    run by ``main``)."""
    n = args.nproc_per_node or 1
    lines = [
        "#!/bin/bash",
        f"#SBATCH --job-name={args.job_name}",
        f"#SBATCH --nodes={args.nodes}",
        f"#SBATCH --ntasks-per-node={n}",
        f"#SBATCH --gpus-per-node={n}",
        "#SBATCH --requeue",
        "#SBATCH --open-mode=append",
        # warning before SLURM kills the job: the trainer saves `latest`
        f"#SBATCH --signal=USR1@{args.signal_delay_s}",
    ]
    if args.partition:
        lines.append(f"#SBATCH --partition={args.partition}")
    if args.time:
        lines.append(f"#SBATCH --time={args.time}")
    backend = f" --backend {args.backend}" if args.backend else ""
    lines += [
        "",
        # resume=True on requeue restarts from the exp-dir snapshot
        f"srun {sys.executable} -m pq3d_tpu_torch.launch --mode slurm"
        f"{backend} -- {' '.join(run_args)} resume=True",
        "",
    ]
    path = args.sbatch_file or "launch.sbatch"
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def rank_device(local_rank: int, local_world: int,
                devices: Optional[List[str]]) -> str:
    """The device of local rank ``local_rank``: its entry of ``devices``,
    else ``cuda:{local_rank}``; raises when the local ranks outnumber the
    cards and no ``devices`` are given."""
    if devices:
        if len(devices) != local_world:
            raise ValueError(f"--devices lists {len(devices)} devices for "
                             f"{local_world} local ranks")
        return devices[local_rank]
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_world > cards:
        raise RuntimeError(
            f"{local_world} local ranks but {cards} CUDA card(s): pass "
            f"--devices (e.g. cpu,cpu on the host, cuda:0,cuda:0 for two "
            f"ranks on one card)")
    return f"cuda:{local_rank}"


def default_backend(device: str) -> str:
    return "nccl" if device.startswith("cuda") else "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_local(args, run_args: Sequence[str]) -> int:
    """Start ``--nproc-per-node`` ranks on this host and wait for them;
    returns the first failing rank's exit code, or 0.  SIGTERM, SIGINT
    and SIGUSR1 are passed on to every rank."""
    n = args.nproc_per_node
    devices = args.devices.split(",") if args.devices else None
    # validate before any process starts
    rank_device(0, n, devices)
    port = args.master_port or _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        cmd = [sys.executable, "-m", "pq3d_tpu_torch.launch", "--mode",
               "dist", "--entry", args.entry]
        if args.backend:
            cmd += ["--backend", args.backend]
        if args.devices:
            cmd += ["--devices", args.devices]
        procs.append(subprocess.Popen(cmd + ["--", *run_args], env=env))

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)
    old = {s: signal.signal(s, forward)
           for s in (signal.SIGTERM, signal.SIGINT, signal.SIGUSR1)}
    rc = 0
    failed: List[Tuple[int, int]] = []
    try:
        while [p.poll() for p in procs].count(None):
            failed = [(r, p.returncode) for r, p in enumerate(procs)
                      if p.returncode not in (None, 0)]
            if failed:
                rc = failed[0][1]
                break
            time.sleep(0.2)
        else:
            failed = [(r, p.returncode) for r, p in enumerate(procs)
                      if p.returncode]
            rc = failed[0][1] if failed else 0
    finally:
        for p in procs:         # a rank failed: the others would wait on
            if p.poll() is None:    # it in a collective until the timeout
                p.kill()
        for p in procs:
            p.wait()
        for s, h in old.items():
            signal.signal(s, h)
    if rc:
        which = ", ".join(
            f"rank {r} with {c}" + (f" ({signal.strsignal(-c)})"
                                    if c < 0 else "")
            for r, c in failed)
        print(f"[launch] a rank exited with {rc} ({which}); stopped the "
              f"others", file=sys.stderr)
    return rc


def run_rank(args, run_args: Sequence[str]) -> None:
    """One rank (``dist`` or ``slurm`` mode): join the group on this
    rank's device, call the entry, leave the group.  The entry finds in
    ``os.environ[RANK_WALL_ENV]`` (JSON) when this rank reached this
    function (``main``), ended its imports (``imports``: torch) and joined
    the group (``group``), on the wall clock, for a caller that splits a
    launch's start-up time."""
    wall = {"main": time.time()}
    from pq3d_tpu_torch.parallel import dist
    wall["imports"] = time.time()
    env = dist.env_ranks(args.mode)
    rank = args.rank if args.rank is not None else env["rank"]
    world = args.world_size if args.world_size is not None else env["world"]
    local = args.local_rank if args.local_rank is not None \
        else env["local_rank"]
    local_world = env["local_world"] or world
    devices = args.devices.split(",") if args.devices else None
    device = rank_device(local or 0, local_world, devices)
    if device.startswith("cuda"):
        import torch
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(args.backend or default_backend(device), rank,
                            world, args.master_addr or env["addr"],
                            args.master_port or env["port"])
    wall["group"] = time.time()
    os.environ[RANK_WALL_ENV] = json.dumps(wall)
    call_entry(args.entry, [*run_args, f"device={device}"])
    dist.destroy_process_group()


def absolute_config(run_args: Sequence[str]) -> List[str]:
    """The runner's arguments with a ``--config-name`` that names an
    existing file made absolute, so every rank, and a requeued SLURM job,
    reads the caller's file whatever its working directory (a packaged
    config's bare name stays as it is)."""
    out = list(run_args)
    for i, arg in enumerate(out):
        if arg == "--config-name" and i + 1 < len(out) \
                and os.path.exists(out[i + 1]):
            out[i + 1] = os.path.abspath(out[i + 1])
        elif arg.startswith("--config-name=") \
                and os.path.exists(arg.partition("=")[2]):
            out[i] = "--config-name=" + os.path.abspath(
                arg.partition("=")[2])
    return out


def call_entry(entry: str, run_args: Sequence[str]):
    module, _, fn = entry.partition(":")
    return getattr(importlib.import_module(module), fn or "main")(
        list(run_args))


def parse_args(argv=None):
    p = argparse.ArgumentParser("pq3d_tpu_torch.launch")
    p.add_argument("--mode", default=None,
                   choices=["python", "dist", "slurm", "submit"],
                   help="default: python, or the local ranks of "
                        "--nproc-per-node")
    p.add_argument("--nproc-per-node", type=int, default=None,
                   help="start this many local ranks of one group")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="default: nccl on cards, gloo on the host")
    p.add_argument("--devices", default=None,
                   help="each local rank's device, comma-separated "
                        "(cpu,cpu or cuda:0,cuda:0)")
    p.add_argument("--entry", default=DEFAULT_ENTRY,
                   help="MODULE:FUNCTION each rank calls with the "
                        "runner's arguments")
    p.add_argument("--master-addr", default=None)
    p.add_argument("--master-port", type=int, default=None)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--world-size", type=int, default=None)
    p.add_argument("--local-rank", type=int, default=None)
    p.add_argument("--nodes", type=int, default=1)
    p.add_argument("--partition", default=None)
    p.add_argument("--time", default=None)
    p.add_argument("--job-name", default="pq3d_tpu_torch")
    p.add_argument("--signal-delay-s", type=int, default=120)
    p.add_argument("--sbatch-file", default=None)
    p.add_argument("run_args", nargs=argparse.REMAINDER,
                   help="arguments of pq3d_tpu_torch.run (after --)")
    args = p.parse_args(argv)
    run_args = list(args.run_args)
    if run_args and run_args[0] == "--":
        run_args = run_args[1:]
    run_args = absolute_config(run_args)
    if any(a.startswith("device=") for a in run_args) and \
            (args.nproc_per_node or args.devices
             or args.mode in ("dist", "slurm")):
        raise ValueError("the launcher sets each rank's device: pass "
                         "--devices instead of device=...")
    if args.mode is None:
        args.mode = "dist" if args.nproc_per_node else "python"
    if args.nproc_per_node is not None and args.nproc_per_node < 1:
        raise ValueError("--nproc-per-node must be at least 1")
    if args.mode in ("python", "slurm") and args.nproc_per_node:
        raise ValueError(f"--mode {args.mode} starts no local ranks: "
                         f"--nproc-per-node goes with dist (or submit)")
    return args, run_args


def main(argv=None) -> int:
    args, run_args = parse_args(argv)
    if args.mode == "submit":
        path = submit_slurm(args, run_args)
        print(f"[launch] wrote {path}")
        subprocess.run(["sbatch", path], check=True)
        return 0
    if args.mode == "dist" and args.nproc_per_node:
        return spawn_local(args, run_args)
    if args.mode == "python":
        if args.devices:
            if "," in args.devices:
                raise ValueError("one process takes one device")
            run_args = [*run_args, f"device={args.devices}"]
        call_entry(args.entry, run_args)
        return 0
    run_rank(args, run_args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
