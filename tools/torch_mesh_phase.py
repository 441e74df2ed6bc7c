#!/usr/bin/env python3
"""Phase ``mesh`` of chip_smoke.py alone, in a fresh process, on one card,
after a probe of the collectives it rests on.

    python3 tools/torch_mesh_phase.py          # probe, phase ddp, phase mesh
                                               # (on the launch's mesh runs)
    python3 tools/torch_mesh_phase.py --probe  # the probe alone
    python3 tools/torch_mesh_phase.py --save-ddp-records PATH
        # and phase ddp's records written to PATH
    python3 tools/torch_mesh_phase.py --ddp-records PATH
        # phase mesh on phase ddp's records from an earlier call, its two
        # runs in a launch of their own
    python3 tools/torch_mesh_phase.py --ddp-records PATH --crowd-gib N \
        [--alloc-conf VALUE]
        # phase mesh's tensor-parallel launch alone while this process
        # holds N GiB of the card, the ranks' allocator set to VALUE
        # ('' for the default) in place of chip_smoke.MESH_ALLOC_CONF

The probe starts 2 gloo ranks on cuda:0 through the launcher and tries,
on CUDA tensors and on their host copies, each collective the mesh could
use: ``all_reduce``, ``all_gather`` (a list), ``all_gather_into_tensor``
and ``reduce_scatter_tensor``; it prints, for each, whether gloo took it
and whether the result is right, and then runs the mesh's own
``Mesh.all_reduce`` / ``all_gather`` / ``reduce_scatter`` on CUDA
tensors.  Phase mesh needs phase ddp's records (its one-rank step 1
losses and 2-rank steps/s), so the tool runs phase ddp first, as
chip_smoke.py does.  Builds kernel B1 first.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
import chip_smoke  # noqa: E402


def probe_rank(argv):
    """One rank of the probe (``--entry torch_mesh_phase:probe_rank``)."""
    import torch
    import torch.distributed as tdist
    from pq3d_tpu_torch.parallel import dist
    from pq3d_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    rank, world = dist.rank(), dist.world()
    out = {"rank": rank, "backend": tdist.get_backend(),
           "torch": torch.__version__}
    for where in ("cuda", "cpu"):
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if where == "cuda" else torch.device("cpu")

        def mine():
            return torch.arange(4, dtype=torch.float32, device=dev) \
                + 10 * rank
        cases = {
            "all_reduce": (lambda: (lambda t: (tdist.all_reduce(t), t)[1])(
                mine()), sum(torch.arange(4.0) + 10 * r
                             for r in range(world))),
            "all_gather": (lambda: (lambda parts: (tdist.all_gather(
                parts, mine()), torch.cat(parts))[1])(
                [torch.empty(4, device=dev) for _ in range(world)]),
                torch.cat([torch.arange(4.0) + 10 * r
                           for r in range(world)])),
            "all_gather_into_tensor": (lambda: (lambda o: (
                tdist.all_gather_into_tensor(o, mine()), o)[1])(
                torch.empty(4 * world, device=dev)),
                torch.cat([torch.arange(4.0) + 10 * r
                           for r in range(world)])),
            "reduce_scatter_tensor": (lambda: (lambda o: (
                tdist.reduce_scatter_tensor(
                    o, torch.cat([mine()] * world)), o)[1])(
                torch.empty(4, device=dev)),
                sum(torch.arange(4.0) + 10 * r for r in range(world))),
        }
        for name, (run, want) in cases.items():
            try:
                got = run()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                ok = bool(torch.equal(got.cpu(), want))
                out[f"{where}:{name}"] = "ok" if ok else f"wrong {got}"
            except Exception as e:       # the probe records the refusal
                out[f"{where}:{name}"] = f"{type(e).__name__}: " \
                    f"{str(e).splitlines()[0][:160]}"
            tdist.barrier()
    mesh = make_mesh(MeshConfig(tp=world))
    t = torch.arange(4, dtype=torch.float32, device="cuda") + 10 * rank
    summed = mesh.all_reduce(t, mesh.tp_group)
    gathered = mesh.all_gather(t, mesh.tp_group, world).reshape(-1)
    scattered = mesh.reduce_scatter(torch.cat([t] * world), mesh.tp_group,
                                    world)
    out["mesh_backend"] = mesh.backend
    out["mesh_all_reduce"] = bool(torch.equal(
        summed.cpu(), sum(torch.arange(4.0) + 10 * r for r in range(world))))
    out["mesh_all_gather"] = bool(torch.equal(
        gathered.cpu(), torch.cat([torch.arange(4.0) + 10 * r
                                   for r in range(world)])))
    out["mesh_reduce_scatter"] = bool(torch.equal(
        scattered.cpu(), sum(torch.arange(4.0) + 10 * r
                             for r in range(world))))
    out["mesh_result_device"] = str(summed.device)
    print("probe " + json.dumps(out), flush=True)


def probe():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE), HERE]))
    proc = subprocess.run(
        [sys.executable, "-m", "pq3d_tpu_torch.launch", "--nproc-per-node",
         "2", "--backend", "gloo", "--devices", "cuda:0,cuda:0", "--entry",
         "torch_mesh_phase:probe_rank", "--"],
        cwd=os.path.dirname(HERE), env=env, capture_output=True, text=True,
        timeout=300)
    for line in proc.stdout.splitlines():
        if line.startswith("probe "):
            print(line, flush=True)
    if proc.returncode:
        print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
        chip_smoke.fail(f"probe exited {proc.returncode}")


def split_probe(card):
    """Where a batch's forward and its two halves' forwards part: the
    full-width stage-1 model (phase 5b's caps, rect, exact FPS, self-mask
    off, f32 sparse convs) on a batch of 4 of phase 5b's scenes and on its
    rows 0-1 and 2-3 (each half routed by its own rows); every module's
    output against the full forward's rows, in call order (a repeat of the
    full forward gives the run-to-run floor)."""
    import dataclasses
    import numpy as np
    import torch
    from pq3d_tpu_torch.config import serving_config
    from pq3d_tpu_torch.data.instseg_pipeline import (collate_processed,
                                                      pipeline_config,
                                                      process_scene)
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.ops import sparse
    from pq3d_tpu_torch.serve import split_rows, to_device
    cfg = serving_config(
        "rect", [f"data.instseg_options.level_caps={chip_smoke.LAYOUT_CAPS}"])
    pipe = dataclasses.replace(pipeline_config(cfg["data"]
                                               ["instseg_options"]),
                               fps_subsample=0)
    model = build_model(cfg, device="cuda", seed=0).eval()
    model.unified_encoder.use_self_mask = False
    sparse._round = lambda t, dtype: t.float()
    rng = np.random.default_rng(0)
    scenes = chip_smoke.make_scenes(4, seed=3)
    b = collate_processed([process_scene(s, pipe, rng) for s in scenes],
                          pipe)
    b.pop("_meta")
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = np.zeros((4, pipe.max_segments, 768),
                                        np.float32)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, a, out, n=n: seen.append((n, out)))
        for n, m in model.named_modules() if n and n.count(".") <= 3]

    def run(batch):
        seen.clear()
        with torch.inference_mode():
            model(to_device(batch, torch.device("cuda")))
        torch.cuda.synchronize()
        return [(n, o) for n, o in seen if torch.is_tensor(o)]
    full = run(b)
    again = run(b)
    halves = [run(split_rows(b, 2 * i, 2 * i + 2, 4)) for i in (0, 1)]
    for h in hooks:
        h.remove()
    firsts = []
    for k, ((n, f), (_, g)) in enumerate(zip(full, again)):
        floor = chip_smoke.rel_err(g.float(), f.float())
        parts = []
        for i, half in enumerate(halves):
            if k >= len(half) or half[k][0] != n:
                parts.append(None)
                continue
            h = half[k][1].float()
            if f.shape[0] == 2 * h.shape[0]:
                ref = f.float()[i * h.shape[0]:(i + 1) * h.shape[0]]
            elif f.shape == h.shape:
                ref = f.float()
            else:
                parts.append(f"shape {tuple(f.shape)} / {tuple(h.shape)}")
                continue
            parts.append(chip_smoke.rel_err(h, ref))
        worst = max((p for p in parts if isinstance(p, float)), default=0)
        if worst > 1e-6 and len(firsts) < 12:
            firsts.append(f"{n} {tuple(f.shape)}: halves {parts}, repeat "
                          f"{floor:.2e}")
    print(f"split probe: {len(full)} module outputs; the first parting "
          f"from the full batch's rows by more than 1e-6 ({card}):",
          flush=True)
    for line in firsts:
        print(f"split probe: {line}", flush=True)


def crowd(card, args):
    """The tensor-parallel launch of phase mesh while this process holds
    ``args.crowd_gib`` GiB of the card."""
    import shutil
    import tempfile
    import torch
    held = torch.empty(int(args.crowd_gib * 2**30), dtype=torch.uint8,
                       device="cuda")
    free, total = torch.cuda.mem_get_info()
    print(f"crowd: this process holds {held.numel() / 2**30:.2f} GiB; the "
          f"card has {free / 2**30:.2f} of {total / 2**30:.2f} GiB free; "
          f"the ranks' PYTORCH_CUDA_ALLOC_CONF "
          f"{chip_smoke.MESH_ALLOC_CONF!r} ({card})", flush=True)
    with open(args.ddp_records) as f:
        dd = json.load(f)
    work = tempfile.mkdtemp(prefix="pq3d_mesh_")
    try:
        chip_smoke.mesh_train_phase(card, dd, work, labels=("stage2_tp",))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main():
    import torch
    from pq3d_tpu_torch.ops import zrun_conv
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--probe", action="store_true",
                    help="run the probe of the collectives alone")
    ap.add_argument("--ddp-records", metavar="PATH",
                    help="phase ddp's records from an earlier call, in "
                         "place of running it")
    ap.add_argument("--save-ddp-records", metavar="PATH",
                    help="write phase ddp's records to PATH")
    ap.add_argument("--crowd-gib", type=float, metavar="N",
                    help="hold N GiB of the card here and run the "
                         "tensor-parallel launch alone (with "
                         "--ddp-records)")
    ap.add_argument("--alloc-conf", metavar="VALUE",
                    help="the mesh ranks' PYTORCH_CUDA_ALLOC_CONF ('' for "
                         "the default allocator)")
    ap.add_argument("--split-probe", action="store_true",
                    help="first, where a batch's forward and its halves' "
                         "part (split_probe)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    if args.alloc_conf is not None:
        chip_smoke.MESH_ALLOC_CONF = args.alloc_conf
    if args.crowd_gib is not None:
        crowd(card, args)
        return
    t0 = time.time()
    if not args.ddp_records:
        probe()
        print(f"probe: {time.time() - t0:.1f} s", flush=True)
        if args.probe:
            return
    zrun_conv.build()
    if args.split_probe:
        split_probe(card)
    t0 = time.time()
    if args.ddp_records:
        with open(args.ddp_records) as f:
            dd = json.load(f)
        dd.pop("mesh_runs", None)       # phase mesh launches its runs anew
    else:
        dd = chip_smoke.ddp_phase(card, zrun_conv)
        print(f"ddp phase: {time.time() - t0:.1f} s", flush=True)
        if args.save_ddp_records:
            with open(args.save_ddp_records, "w") as f:
                json.dump(dd, f)
    chip_smoke.mesh_phase(card, zrun_conv, dd)


if __name__ == "__main__":
    main()
