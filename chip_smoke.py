#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pq3d_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero, nothing is skipped):

1. device   -- requires CUDA; prints the card's name and power limit;
2. build    -- builds csrc/zrun_conv.cu with nvcc (sm_90a) from this
               checkout and prints the build seconds;
3. kernel   -- the z-run 3^3 conv kernel against its plain PyTorch version
               at the routed shapes of the serving slice (maps from the
               port's pipeline on a full-size synthetic batch): error, median
               time over 20 launches (CUDA events), plain time, bound;
4. serve    -- the slice end to end: the full-width stage-1 model
               (instseg_sceneverse + pallas_conv: true, random weights from
               a seed) behind InstSegServer(batch_size=4) answers 8 scenes of
               60-80k points; checks every answer and that the kernel ran
               exactly routed-convs x forwards times;
5. check    -- the served forward against the same model with every conv on
               its plain version, on one batch;
then one JSON line with every hand kernel's numbers, and the result line.

    python3 chip_smoke.py --profile PATH

adds, after phase 5, a torch.profiler trace of one served forward: device
busy time against the host clock and the device time by kernel (the top
rows printed, the whole table written to PATH).
"""
import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published peaks (dense bf16 tensor-core rate, device-memory rate)
PEAKS = {"H200": (989e12, 4.8e12), "H100": (989e12, 3.35e12)}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def peaks_for(name):
    for key, val in PEAKS.items():
        if key in name:
            return val
    fail(f"no published peak rates for {name!r}")


def cuda_time(fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def settle(srv, scenes):
    """Wait (bounded) until the server's worker has booked ``scenes``: it
    resolves the futures first and updates its stats just after."""
    deadline = time.time() + 30
    while srv.stats.scenes < scenes and time.time() < deadline:
        time.sleep(0.01)
    if srv.stats.scenes < scenes:
        fail(f"server booked {srv.stats.scenes} of {scenes} scenes")


def level_rows(batch):
    """Flat rows per hierarchy level of a collated (numpy or torch) batch."""
    return [math.prod(batch["maps"][f"valid_{l}"].shape) for l in range(5)]


def make_scenes(n, seed):
    import numpy as np
    from pq3d_tpu_torch.data import synthetic
    rng = np.random.default_rng(seed)
    scenes = [synthetic.make_scene(rng, n_points=60_000 + 5000 * (i % 5),
                                   n_instances=24, n_segments=400)
              for i in range(n)]
    for s in scenes:
        s["inst_labels"] = np.minimum(s["inst_labels"], 199)
    return scenes


def profile_forward(model, batch, path):
    """Trace one forward (after a warm one): device busy ms (the union of
    kernel intervals) against the host clock, and device ms by kernel (the
    whole table written to ``path``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            model(batch)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        fail("the profiler recorded no device time")
    busy_us, end = 0.0, -math.inf
    for s, e in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    print(f"profile: forward {wall_ms:.1f} ms (host clock), device busy "
          f"{busy_us / 1e3:.1f} ms ({len(spans)} kernels), idle share "
          f"{1 - busy_us / 1e3 / wall_ms:.3f}", flush=True)
    for name, us in top[:12]:
        print(f"profile:   {us / 1e3:8.3f} ms  {name[:100]}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for name, us in top:
            f.write(f"{us / 1e3:.4f}\t{name}\n")
        f.write(prof.key_averages().table(sort_by="device_time_total",
                                          row_limit=60))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="trace one served forward; write the table here")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "pq3d_tpu_torch")):
        fail("pq3d_tpu_torch/ is not beside chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    import warnings
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from pq3d_tpu_torch.config import slice_config
    from pq3d_tpu_torch.data.instseg_pipeline import (make_batch,
                                                      pipeline_config)
    from pq3d_tpu_torch.eval.instseg_eval import rank_instances
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.models.sparse_unet import flatten_maps
    from pq3d_tpu_torch.ops import zrun_conv
    from pq3d_tpu_torch.serve import InstSegServer, to_device

    # the synthetic scenes outgrow the YAML's deep level caps; the pipeline
    # pads those levels to buckets (the printed level rows show it)
    warnings.filterwarnings("ignore", message="level .* > configured cap")

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "unknown"
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}", flush=True)
    flops_peak, bw_peak = peaks_for(kind)
    dev = torch.device("cuda")

    # ---- 2. build -------------------------------------------------------
    t0 = time.time()
    zrun_conv.build()
    print(f"build: zrun_conv.cu {time.time() - t0:.1f} s", flush=True)

    # ---- 3. kernel against its plain version at the routed shapes -------
    cfg = slice_config()
    pipe = pipeline_config(cfg["data"]["instseg_options"])
    t0 = time.time()
    model = build_model(cfg, device="cuda", seed=0)
    backbone = model.voxel_encoder.backbone
    print(f"model: built in {time.time() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params",
          flush=True)
    t0 = time.time()
    batch = make_batch(make_scenes(4, seed=1), pipe,
                       np.random.default_rng(0))
    rows = level_rows(batch)
    most = [int(batch["maps"][f"valid_{l}"].sum(1).max()) for l in range(5)]
    print(f"pipeline: 4 scenes collated in {time.time() - t0:.1f} s, flat "
          f"level rows {rows}, most voxels in one scene per level {most} "
          f"(level caps {pipe.level_caps})", flush=True)
    fm = flatten_maps(to_device(batch["maps"], dev))
    gen = torch.Generator(device="cpu").manual_seed(0)
    routed = backbone.routed_convs(rows)
    shapes = {}          # (level, cin, cout) -> routed convs per forward
    for _, lvl, cin, cout in routed:
        shapes[(lvl, cin, cout)] = shapes.get((lvl, cin, cout), 0) + 1
    print(f"routing: {len(routed)} convs per forward run zrun_conv: "
          f"{[r[0] for r in routed]}", flush=True)
    if not routed:
        fail("no conv of the slice routes to zrun_conv")
    per_shape = []
    for (lvl, cin, cout), per_fwd in sorted(shapes.items()):
        nbr, valid = fm[f"nbr3_{lvl}"], fm[f"valid_{lvl}"]
        n = nbr.shape[0]
        if not zrun_conv.applicable(n, cin, cout):
            fail(f"shape (N={n}, {cin}->{cout}) does not route")
        zb, zc = zrun_conv.zrun_plan(nbr)
        x = torch.randn(n, cin, generator=gen).to(dev) * valid[:, None]
        w = (torch.randn(27, cin, cout, generator=gen) * 0.05).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            got = zrun_conv.zrun_conv(xd, w, zb, zc, valid)
            ref = zrun_conv.zrun_conv_reference(xd, w, zb, zc, valid)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs().max().item()
            rel = diff / max(ref.float().abs().max().item(), 1e-12)
            if not (rel <= 1e-2 and torch.isfinite(got).all().item()):
                fail(f"zrun_conv disagrees with its plain version at "
                     f"L{lvl} {cin}->{cout} {dt}: rel {rel:.3e}")
            if dt is torch.float32:      # the main path feeds f32 x
                ms = cuda_time(lambda: zrun_conv.zrun_conv(xd, w, zb, zc,
                                                           valid), 20)
                plain_ms = cuda_time(lambda: zrun_conv.zrun_conv_reference(
                    xd, w, zb, zc, valid), 5)
                pairs = int((zc != -2).sum().item())
                flops = 2.0 * pairs * cin * cout
                nbytes = (n * cin * 4 + 27 * cin * cout * 2 + n * 9 * 4
                          + n * 27 + n + n * cout * 4)
                t_ops, t_bytes = flops / flops_peak * 1e3, \
                    nbytes / bw_peak * 1e3
                rec = {"level": lvl, "n": n, "cin": cin, "cout": cout,
                       "per_forward": per_fwd, "ms": ms,
                       "plain_ms": plain_ms,
                       "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes
                       else "bytes",
                       "flops": flops, "dense27_flops":
                           2.0 * n * 27 * cin * cout, "bytes": nbytes}
            rec[f"max_abs_err_{'f32' if dt is torch.float32 else 'bf16'}"] \
                = diff
            rec[f"max_rel_err_{'f32' if dt is torch.float32 else 'bf16'}"] \
                = rel
        per_shape.append(rec)
        print(f"kernel: zrun_conv L{lvl} N={n} {cin}->{cout} "
              f"rel_err f32 {rec['max_rel_err_f32']:.2e} "
              f"bf16 {rec['max_rel_err_bf16']:.2e} | {rec['ms']:.3f} ms "
              f"(plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f}"
              f" ms by {rec['bound_by']}, {rec['flops'] / rec['ms'] / 1e9:.1f}"
              f" TFLOP/s on valid taps)", flush=True)
        del x, w, zb, zc
    torch.cuda.empty_cache()

    # ---- 4. serve -------------------------------------------------------
    expected = []        # routed convs of each forward the server runs
    model.register_forward_pre_hook(
        lambda mod, args: expected.append(len(backbone.routed_convs(
            level_rows(args[0])))))
    srv = InstSegServer(model, pipe, batch_size=4, num_classes=200, topk=100,
                        max_delay_s=0.02,
                        extra_features={"mv": 768, "pc": 768}, device="cuda")
    try:
        warm = make_scenes(4, seed=2)
        zrun_conv.launches = 0
        for f in [srv.submit(s) for s in warm]:
            f.result(timeout=900)
        settle(srv, len(warm))
        if zrun_conv.launches != sum(expected):
            fail(f"warm-up ran zrun_conv {zrun_conv.launches} times; "
                 f"routing expects {expected}")
        srv.stats = type(srv.stats)()
        expected.clear()
        torch.cuda.reset_peak_memory_stats()
        scenes = make_scenes(8, seed=3)
        zrun_conv.launches = 0              # main path starts here
        t0 = time.time()
        results = [f.result(timeout=900)
                   for f in [srv.submit(s) for s in scenes]]
        wall = time.time() - t0
        settle(srv, len(scenes))
        main_launches = zrun_conv.launches  # main path ends here
    finally:
        srv.close()
    st = srv.stats.summary()
    if st["scenes"] != 8 or main_launches != sum(expected) \
            or len(expected) != st["steps"]:
        fail(f"zrun_conv launches {main_launches} != routed convs per "
             f"forward {expected} (scenes {st['scenes']})")
    n_inst = 0
    for s, preds in zip(scenes, results):
        if not isinstance(preds, list):
            fail("a request did not resolve to a prediction list")
        for p in preds:
            if p["mask"].shape != (len(s["points"]),) \
                    or not np.isfinite(p["score"]) \
                    or not 0 <= p["class"] < 200:
                fail("an instance has a wrong mask shape, score or class")
        n_inst += len(preds)
    stages = " ".join(f"{k}={v:.3f}s" for k, v in sorted(
        st["stage_s"].items()))
    print(f"serve: {st['scenes']} scenes in {st['steps']} forwards, "
          f"{n_inst} instances | {st['scenes_per_sec']:.3f} scenes/s "
          f"(wall {wall:.2f} s) p50 {st['p50_latency_s'] * 1e3:.1f} ms "
          f"p99 {st['p99_latency_s'] * 1e3:.1f} ms | {stages} | "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
          f"zrun_conv launches {main_launches} = routed convs per forward "
          f"{expected} ({card})", flush=True)

    # ---- 5. check: served forward vs every conv on its plain version ----
    b = to_device({k: v for k, v in batch.items() if k != "_meta"}, dev)
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = torch.zeros(4, pipe.max_segments, 768,
                                           device=dev)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    enc_out = {}
    model.voxel_encoder.register_forward_hook(
        lambda mod, args, out: enc_out.__setitem__("scales", out))
    backbone.register_forward_hook(
        lambda mod, args, out: enc_out.__setitem__("maps",
                                                   [out[0]] + out[1]))
    outs = {}
    for use_kernel in (True, False):
        backbone.pallas_conv = use_kernel
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            out = model(b)
        torch.cuda.synchronize()
        outs[use_kernel] = {
            "t": time.time() - t0, "maps": enc_out["maps"],
            "scales": enc_out["scales"],
            "cls": [c.float() for c in out["predictions_class"]],
            "mask": [m.float() for m in out["predictions_mask"]]}
    backbone.pallas_conv = True
    got, ref = outs[True], outs[False]

    def rel(a, r):
        return ((a.float() - r.float()).abs().max()
                / r.float().abs().max().clamp_min(1e-12)).item()
    # what the routed convs feed: the U-Net's output and feature maps and
    # the segment features pooled from them, held at the CPU tests' 2e-2
    feat_rel = max(rel(a, r) for a, r in zip(got["maps"] + got["scales"],
                                            ref["maps"] + ref["scales"]))
    seg_valid = b["seg_pad_masks"][:, :, None]
    mvalid = seg_valid.expand_as(got["mask"][-1])
    keep = torch.ones(got["cls"][-1].shape[-1], dtype=torch.bool, device=dev)
    keep[[0, 2]] = False
    cls_rel = rel(got["cls"][-1][..., keep], ref["cls"][-1][..., keep])
    mask_rel = rel(got["mask"][-1][mvalid], ref["mask"][-1][mvalid])
    # self-mask attend bits (logit >= 0) that differ per decoder round: a
    # logit within rounding of 0 flips, and the rounds after it diverge
    flips = [int((((g >= 0) != (r >= 0)) & seg_valid).sum().item())
             for g, r in zip(got["mask"], ref["mask"])]
    finite = all(torch.isfinite(t).all().item()
                 for t in got["cls"][-1:] + got["mask"][-1:])
    nonneg = int(((got["mask"][-1] >= 0) & seg_valid).sum().item())
    print(f"check: forward with the kernel vs all-plain: features rel "
          f"{feat_rel:.2e} | final class rel {cls_rel:.2e}, mask rel "
          f"{mask_rel:.2e}, attend bits differing per round {flips} | "
          f"final mask logits >= 0: {nonneg} of {int(mvalid.sum().item())} "
          f"| forward {got['t'] * 1e3:.1f} ms vs plain {ref['t'] * 1e3:.1f}"
          f" ms (host clock)", flush=True)
    if not (finite and feat_rel <= 2e-2):
        fail("the served forward disagrees with its plain twin")
    # the full-resolution answer path on this batch's first decoder round,
    # whose masks are not empty under random weights (the final round's
    # may all be negative, so the served lists above may be empty)
    meta = batch["_meta"]
    n_ranked = 0
    for i in range(4):
        preds = rank_instances(
            got["cls"][1][i].cpu().numpy(), got["mask"][1][i].cpu().numpy(),
            batch["seg_pad_masks"][i], num_classes=200, topk=100,
            seg_to_full=meta["segment_to_full"][i])
        n_points = len(meta["segment_to_full"][i])
        for p in preds:
            if p["mask"].shape != (n_points,) or not np.isfinite(p["score"]):
                fail("a ranked instance has a wrong mask shape or score")
        n_ranked += len(preds)
    print(f"rank: round-1 logits of the checked batch give {n_ranked} "
          f"instances with full-resolution masks", flush=True)
    if n_ranked == 0:
        fail("no instance ranked from the round-1 logits")

    if args.profile:
        profile_forward(model, b, args.profile)

    # ---- kernels line + result -----------------------------------------
    def per_fwd(key):
        return sum(r[key] * r["per_forward"] for r in per_shape)
    bound = per_fwd("bound_ms")
    entry = {
        "name": "zrun_conv", "route": "cuda",
        "source": "pq3d_tpu_torch/csrc/zrun_conv.cu",
        "replaces": "pq3d_tpu/ops/pallas_zt.py:386",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err_f32"] for r in per_shape),
        "ms": per_fwd("ms"), "plain_ms": per_fwd("plain_ms"),
        "bound_ms": bound,
        "bound_by": max(per_shape, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": None,
        "scope": f"sum over the {len(routed)} routed convs of one forward "
                 f"(B=4)",
        "shapes": per_shape,
    }
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
