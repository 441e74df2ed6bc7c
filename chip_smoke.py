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
6. kernel_bwd -- the kernel's backward (dx: the same kernel on the masked dy
               with W flipped and transposed; dW: the plain re-gather)
               through its autograd Function against the plain backward,
               at the routed shapes of a full-size training batch: error,
               the dx kernel's median ms over 20 launches, plain ms, bound,
               and the dW re-gather's ms;
7. train    -- stage-1 training end to end: pq3d_tpu_torch.run builds the
               trainer (instseg_sceneverse + pallas_conv: true, batch 4 of
               synthetic 70k-point scenes, AdamW); 1 warm step, 5 timed
               steps (loss, grad norm, host-pipeline s, device ms per step;
               steps/s, scenes/s, peak memory; the kernel's forward and
               backward launches, which must be 2 x routed convs per step),
               then 5 steps on one batch whose loss must fall;
8. train_check -- one train step (dropout off) with the kernel against
               the same step all-plain (loss) and with every backward on
               its plain version (routed-conv weight gradients), and each
               routed conv replayed at the step's own x and dy against
               its plain backward, all within 2e-2;
then one JSON line with every hand kernel's numbers, and the result line.

    python3 chip_smoke.py --profile PATH

adds torch.profiler traces of one served forward (after phase 5) and of one
train step (after phase 8): device busy time against the host clock, the
idle share and the device time by kernel (the top rows printed, the whole
tables written to PATH and to PATH with ``_train`` before its extension).
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


def profile_run(fn, label, path):
    """Trace one call of ``fn`` (after a warm one): device busy ms (the
    union of kernel intervals) against the host clock, and device ms by
    kernel (the whole table written to ``path``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
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
    print(f"profile: {label} {wall_ms:.1f} ms (host clock), device busy "
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


def rel_err(got, ref):
    """max|got - ref| / max|ref|."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-12)).item()


def conv_bound(n, cin, cout, pairs, with_valid, flops_peak, bw_peak):
    """(bound ms, what bounds it, flops, bytes) of one z-run conv: the
    valid taps' bf16 products over the tensor-core peak against reading x
    (f32), W (bf16), the plan and the mask once and writing y (f32)."""
    flops = 2.0 * pairs * cin * cout
    nbytes = (n * cin * 4 + 27 * cin * cout * 2 + n * 9 * 4 + n * 27
              + (n if with_valid else 0) + n * cout * 4)
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / bw_peak * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def smoke_trainer(exp_dir):
    """The stage-1 trainer as ``python -m pq3d_tpu_torch.run`` builds it:
    the slice config at full width, batch 4 (the YAML's), AdamW, on
    SyntheticInstSeg scenes of 70k points, 24 instances, 400 segments."""
    from pq3d_tpu_torch import run
    from pq3d_tpu_torch.config import load_config
    cfg = load_config("instseg_sceneverse", [
        "model.voxel_encoder.args.pallas_conv=true",
        "data.train=[SyntheticInstSeg]", "data.val=[SyntheticInstSeg]",
        "data.synthetic.num_train=20", "data.synthetic.num_val=4",
        "data.synthetic.n_points=70000", "data.synthetic.n_instances=24",
        "data.synthetic.n_segments=400", "log_every=1", "device=cuda",
        f"exp_dir={exp_dir}"])
    return run.build_instseg_trainer(cfg)


def kernel_bwd_phase(zrun_conv, fm, shapes, dev, flops_peak, bw_peak):
    """The kernel's backward at each routed shape: dx and dW through the
    autograd Function against the plain backward, then the dx kernel's
    median ms over 20 launches, its plain version's, its bound (Cin and
    Cout swapped: dy in, dx out) and the dW re-gather's ms."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(1)
    recs = []
    for (lvl, cin, cout), per_step in sorted(shapes.items()):
        nbr, valid = fm[f"nbr3_{lvl}"], fm[f"valid_{lvl}"]
        n = nbr.shape[0]
        zb, zc = zrun_conv.zrun_plan(nbr)
        x = torch.randn(n, cin, generator=gen).to(dev) * valid[:, None]
        w = (torch.randn(27, cin, cout, generator=gen) * 0.05).to(dev)
        dy = torch.randn(n, cout, generator=gen).to(dev)
        xg = x.clone().requires_grad_(True)
        wg = w.clone().requires_grad_(True)
        before = zrun_conv.phase_launches["bwd"]
        zrun_conv.zrun_conv_sym(xg, wg, zb, zc, valid).backward(dy)
        if zrun_conv.phase_launches["bwd"] != before + 1:
            fail(f"the backward at L{lvl} {cin}->{cout} did not launch the "
                 f"kernel once")
        dx_ref, dw_ref = zrun_conv.zrun_conv_backward_reference(
            x, w, zb, zc, valid, dy)
        torch.cuda.synchronize()
        rel_dx, rel_dw = rel_err(xg.grad, dx_ref), rel_err(wg.grad, dw_ref)
        finite = bool(torch.isfinite(xg.grad).all().item()
                      and torch.isfinite(wg.grad).all().item())
        if not (finite and rel_dx <= 1e-2 and rel_dw <= 1e-2):
            fail(f"zrun_conv backward disagrees with its plain version at "
                 f"L{lvl} {cin}->{cout}: dx rel {rel_dx:.3e}, dW rel "
                 f"{rel_dw:.3e}")
        dym = torch.where(valid[:, None], dy, 0)
        wt = w.flip(0).transpose(1, 2)
        ms = cuda_time(lambda: zrun_conv.zrun_conv(dym, wt, zb, zc,
                                                   phase="bwd"), 20)
        plain_ms = cuda_time(lambda: zrun_conv.zrun_conv_reference(
            dym, wt, zb, zc), 5)
        dw_ms = cuda_time(lambda: zrun_conv.zrun_weight_grad(x, zb, zc, dym),
                          5)
        pairs = int((zc != -2).sum().item())
        bound, by, flops, nbytes = conv_bound(n, cout, cin, pairs, False,
                                              flops_peak, bw_peak)
        rec = {"level": lvl, "n": n, "cin": cout, "cout": cin,
               "forward": f"{cin}->{cout}", "per_step": per_step, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "dw_ms": dw_ms, "flops": flops, "bytes": nbytes,
               "max_abs_err_dx": (xg.grad - dx_ref).abs().max().item(),
               "max_rel_err_dx": rel_dx, "max_rel_err_dw": rel_dw}
        recs.append(rec)
        print(f"kernel_bwd: zrun_conv dx L{lvl} N={n} {cout}->{cin} "
              f"(forward {cin}->{cout}, {per_step} per step) rel_err dx "
              f"{rel_dx:.2e} dW {rel_dw:.2e} | {ms:.3f} ms (plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms by {by}, "
              f"{flops / ms / 1e9:.1f} TFLOP/s on valid taps) | dW re-gather "
              f"{dw_ms:.3f} ms", flush=True)
        del x, w, dy, xg, wg, dx_ref, dw_ref, dym, zb, zc
    torch.cuda.empty_cache()
    return recs


def train_phase(trainer, zrun_conv, warm, card):
    """1 warm step, then one epoch of 5 timed steps through the trainer
    (its prefetching loader included), then 5 steps on the warm batch.
    Returns the launch counts and the step records."""
    import torch
    model = trainer.model
    backbone = model.voxel_encoder.backbone
    expected = []        # routed convs of each train forward
    hook = model.register_forward_pre_hook(
        lambda mod, args: expected.append(len(backbone.routed_convs(
            level_rows(args[0])))))
    t0 = time.time()
    m = trainer.train_batch(warm)        # builds the optimizer, warms up
    torch.cuda.synchronize()
    print(f"train: warm step {time.time() - t0:.1f} s, loss "
          f"{float(m['loss']):.4f}", flush=True)

    inner, loader = trainer._train_step, trainer.train_data
    steps, host_s = [], []

    def timed_step(batch):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(batch)
        b.record()
        b.synchronize()
        steps.append({"device_ms": a.elapsed_time(b), "end": time.time(),
                      "loss": float(out["loss"]),
                      "grad_norm": float(out["grad_norm"])})
        return out

    def timed_loader(epoch):
        it = iter(loader(epoch))
        while True:
            t = time.time()
            try:
                b = next(it)
            except StopIteration:
                return
            host_s.append(time.time() - t)
            yield b

    trainer._train_step, trainer.train_data = timed_step, timed_loader
    expected.clear()
    torch.cuda.reset_peak_memory_stats()
    zrun_conv.reset_counts()                # main path starts here
    t0 = time.time()
    trainer.train_epoch(0)
    wall = time.time() - t0
    counts = dict(zrun_conv.phase_launches)  # main path ends here
    peak = torch.cuda.max_memory_allocated()
    trainer._train_step, trainer.train_data = inner, loader
    hook.remove()
    for i, (s, h) in enumerate(zip(steps, host_s)):
        print(f"train: step {i + 1} loss {s['loss']:.4f} grad_norm "
              f"{s['grad_norm']:.3f} | host pipeline {h:.3f} s | device "
              f"step {s['device_ms']:.1f} ms", flush=True)
    if len(steps) != 5 or len(expected) != 5:
        fail(f"the epoch ran {len(steps)} steps, expected 5")
    if not all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
               for s in steps):
        fail("a loss or gradient norm is not finite")
    grads = [p.grad for p in model.parameters() if p.requires_grad]
    if any(g is None for g in grads) or not torch.stack(
            [torch.isfinite(g).all() for g in grads]).all().item():
        fail("a trainable parameter has no gradient or a non-finite one")
    routed = sum(expected)
    print(f"train: 5 steps in {wall:.2f} s: {5 / wall:.3f} steps/s, "
          f"{20 / wall:.3f} scenes/s (steady, steps 2-5: "
          f"{4 / (steps[-1]['end'] - steps[0]['end']):.3f} steps/s) | "
          f"max_memory_allocated {peak / 2**30:.2f} GiB | zrun_conv "
          f"launches fwd {counts['fwd']} bwd {counts['bwd']}, routed convs "
          f"per step {expected} ({card})", flush=True)
    if counts["fwd"] != routed or counts["bwd"] != routed:
        fail(f"zrun_conv launches fwd {counts['fwd']} bwd {counts['bwd']} "
             f"!= routed convs {routed} each")

    losses = [float(trainer.train_batch(warm)["loss"]) for _ in range(5)]
    print(f"train: 5 steps on one batch, loss {losses}", flush=True)
    if not losses[-1] < losses[0]:
        fail("the loss did not fall over 5 steps on one batch")
    return {"counts": counts, "routed_per_step": expected, "steps": steps,
            "host_s": host_s, "wall_s": wall, "peak_bytes": peak}


def train_check_phase(trainer, zrun_conv, batch):
    """One train step (dropout off) with the kernel (K) against the same
    step with every conv's backward on its plain version (KP) and with
    every conv on its plain version (P), plus a replay of each routed conv
    at K's own input and output gradient.

    Gates (2e-2): the loss of K against P; the worst routed-weight
    gradient of K against KP; the replay's dx and dW against the plain
    backward.  Printed, not gated: the routed-weight gradients of K
    against P and of K against a second K (the run-to-run floor).  A
    forward whose f32 sums run in another order crosses bf16 rounding and
    ReLU boundaries in the train-mode U-Net, so K against P moves the
    gradients well past what either pass computes differently."""
    import torch
    model = trainer.model
    backbone = model.voxel_encoder.backbone
    drops = [m for m in model.modules() if isinstance(m, torch.nn.Dropout)]
    rates = [m.p for m in drops]
    for m in drops:
        m.p = 0.0
    b = trainer._put(batch)
    names = [r[0] for r in backbone.routed_convs(level_rows(b))]
    kernel, sym = zrun_conv.zrun_conv, zrun_conv.zrun_conv_sym

    def plain_bwd(x, w, zb, zc, out_valid=None, phase="fwd"):
        if phase == "bwd":
            return zrun_conv.zrun_conv_reference(x, w, zb, zc, out_valid)
        return kernel(x, w, zb, zc, out_valid, phase)

    captured = []

    def capturing_sym(x, w, zb, zc, out_valid=None):
        y = sym(x, w, zb, zc, out_valid)
        rec = {"x": x.detach(), "w": w.detach(), "zb": zb, "zc": zc,
               "v": out_valid}
        captured.append(rec)
        y.register_hook(lambda g: rec.__setitem__("dy", g))
        return y

    def step(mode):
        backbone.pallas_conv = mode != "P"
        if mode == "KP":
            zrun_conv.zrun_conv = plain_bwd
        if mode == "K":
            zrun_conv.zrun_conv_sym = capturing_sym
        try:
            model.train()
            model.zero_grad(set_to_none=True)
            out = model(b)
            total, _ = trainer.loss_fn(out, b)
            total.backward()
        finally:
            zrun_conv.zrun_conv, zrun_conv.zrun_conv_sym = kernel, sym
        return total.item(), {n: backbone.get_submodule(n).kernel.grad
                              .clone() for n in names}

    runs = {mode: step(mode) for mode in ("K", "KP", "P", "K2")}
    backbone.pallas_conv = True
    for m, p in zip(drops, rates):
        m.p = p
    model.zero_grad(set_to_none=True)

    def worst(a, c):
        return max(rel_err(runs[a][1][n], runs[c][1][n]) for n in names)
    loss_k, loss_p = runs["K"][0], runs["P"][0]
    loss_rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-12)
    bwd_rel, all_plain_rel, floor = worst("K", "KP"), worst("K", "P"), \
        worst("K", "K2")
    replay_dx = replay_dw = 0.0
    for rec in captured:
        x = rec["x"].clone().requires_grad_(True)
        w = rec["w"].clone().requires_grad_(True)
        sym(x, w, rec["zb"], rec["zc"], rec["v"]).backward(rec["dy"])
        dx_ref, dw_ref = zrun_conv.zrun_conv_backward_reference(
            rec["x"], rec["w"], rec["zb"], rec["zc"], rec["v"], rec["dy"])
        replay_dx = max(replay_dx, rel_err(x.grad, dx_ref))
        replay_dw = max(replay_dw, rel_err(w.grad, dw_ref))
    print(f"train_check: loss {loss_k:.6f} with the kernel vs {loss_p:.6f} "
          f"all-plain (rel {loss_rel:.2e}) | worst gradient rel over the "
          f"{len(names)} routed conv weights: kernel vs plain backward "
          f"{bwd_rel:.2e}; replay of the {len(captured)} routed convs at the "
          f"step's own x and dy: dx {replay_dx:.2e}, dW {replay_dw:.2e} | "
          f"not gated: kernel vs all-plain {all_plain_rel:.2e}, kernel vs "
          f"kernel (run-to-run) {floor:.2e}", flush=True)
    if len(captured) != len(names) or not all("dy" in r for r in captured):
        fail("the replay did not capture every routed conv")
    if not max(loss_rel, bwd_rel, replay_dx, replay_dw) <= 2e-2:
        fail("the train step with the kernel disagrees with its plain "
             "version")
    return {"loss_rel": loss_rel, "bwd_rel": bwd_rel,
            "replay_dx_rel": replay_dx, "replay_dw_rel": replay_dw,
            "all_plain_rel": all_plain_rel, "run_to_run_rel": floor}


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
                bound, by, flops, nbytes = conv_bound(
                    n, cin, cout, pairs, True, flops_peak, bw_peak)
                rec = {"level": lvl, "n": n, "cin": cin, "cout": cout,
                       "per_forward": per_fwd, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": by, "flops": flops, "dense27_flops":
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
        zrun_conv.reset_counts()
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
        zrun_conv.reset_counts()            # main path starts here
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

    rel = rel_err
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
        def served_forward():
            with torch.inference_mode():
                model(b)
        profile_run(served_forward, "served forward", args.profile)
    del model, backbone, srv, outs, got, ref, out, enc_out, b, fm
    torch.cuda.empty_cache()

    # ---- 6. kernel_bwd: the backward at a training batch's shapes -------
    import tempfile
    exp_dir = tempfile.mkdtemp(prefix="pq3d_smoke_")
    try:
        t0 = time.time()
        trainer = smoke_trainer(exp_dir)
        warm = next(iter(trainer.train_data(99)))
        rows = level_rows(warm)
        print(f"train setup: trainer built, one batch of 4 augmented scenes "
              f"collated in {time.time() - t0:.1f} s, flat level rows "
              f"{rows}", flush=True)
        tbackbone = trainer.model.voxel_encoder.backbone
        troutes = tbackbone.routed_convs(rows)
        if not troutes:
            fail("no conv of the training batch routes to zrun_conv")
        bwd_shapes = {}  # (level, forward cin, cout) -> routed per step
        for _, lvl, cin, cout in troutes:
            bwd_shapes[(lvl, cin, cout)] = bwd_shapes.get((lvl, cin, cout),
                                                          0) + 1
        tfm = flatten_maps(to_device(warm["maps"], dev))
        bwd = kernel_bwd_phase(zrun_conv, tfm, bwd_shapes, dev, flops_peak,
                               bw_peak)
        del tfm

        # ---- 7. train ---------------------------------------------------
        tr = train_phase(trainer, zrun_conv, warm, card)

        # ---- 8. train_check ---------------------------------------------
        tc = train_check_phase(trainer, zrun_conv, warm)
        if args.profile:
            stem, ext = os.path.splitext(args.profile)
            profile_run(lambda: trainer.train_batch(warm), "train step",
                        f"{stem}_train{ext}")
    finally:
        import shutil
        shutil.rmtree(exp_dir, ignore_errors=True)

    # ---- kernels line + result -----------------------------------------
    def per_fwd(key):
        return sum(r[key] * r["per_forward"] for r in per_shape)

    def per_step(key):
        return sum(r[key] * r["per_step"] for r in bwd)
    entry = {
        "name": "zrun_conv", "route": "cuda",
        "source": "pq3d_tpu_torch/csrc/zrun_conv.cu",
        "replaces": "pq3d_tpu/ops/pallas_zt.py:386",
        "launches": main_launches + tr["counts"]["fwd"]
        + tr["counts"]["bwd"],
        "launches_by_path": {"serve": main_launches,
                             "train_fwd": tr["counts"]["fwd"],
                             "train_bwd": tr["counts"]["bwd"]},
        "max_abs_err": max(r["max_abs_err_f32"] for r in per_shape),
        "ms": per_fwd("ms"), "plain_ms": per_fwd("plain_ms"),
        "bound_ms": per_fwd("bound_ms"),
        "bound_by": max(per_shape, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": None,
        "scope": f"ms/plain_ms/bound_ms: sum over the {len(routed)} routed "
                 f"convs of one served forward (B=4); bwd_*: sum of the dx "
                 f"launches over the {len(troutes)} routed convs of one "
                 f"train step (B=4); launches: the serving run plus the "
                 f"5 timed train steps",
        "shapes": per_shape,
        "bwd_launches": tr["counts"]["bwd"],
        "bwd_ms": per_step("ms"), "bwd_plain_ms": per_step("plain_ms"),
        "bwd_bound_ms": per_step("bound_ms"),
        "bwd_bound_by": max(bwd, key=lambda r: r["bound_ms"])["bound_by"],
        "bwd_max_abs_err": max(r["max_abs_err_dx"] for r in bwd),
        "dw_regather_ms": per_step("dw_ms"),
        "bwd_shapes": bwd,
        "train_check": tc,
    }
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
