#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pq3d_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero, nothing is skipped):

1. device   -- requires CUDA; prints the card's name and power limit;
2. build    -- builds csrc/zrun_conv.cu and csrc/windowed_conv.cu with nvcc
               (sm_90a) from this checkout, one nvcc each, both started
               together, and prints the build seconds and B1's registers and
               spills per instantiation (ptxas -v);
3. kernel   -- the z-run 3^3 conv kernel (B1) against its plain PyTorch
               version at the routed shapes of the serving slice (maps from
               the port's pipeline on a full-size synthetic batch): error,
               median time over 20 launches (CUDA events), the wrapper's
               host time per call, plain time, bound, the share of the
               N x 27 slots that hold a
               reference beside the share of (tile, tap) pairs the kernel
               stages (128-row tiles) and multiplies (64-row halves), and
               TFLOP/s over both;
4. serve    -- the slice end to end: the full-width stage-1 model
               (instseg_sceneverse + pallas_conv: true, random weights from
               a seed) behind InstSegServer(batch_size=4) answers 8 scenes of
               60-80k points; checks every answer and that B1 ran exactly
               routed-convs x forwards times (and the windowed conv never);
5. check    -- the served forward against the same model with every conv on
               its plain version, on one batch;
6. winconv  -- the windowed conv kernel (B2), which no model calls, on the
               served batch's coordinates rebuilt level by level and put in
               Morton order per scene: per level the host seconds of
               morton_order, build_window_map (tile 256, window 512) and
               fold_exceptions, the out-of-window share of the references,
               the extra slab rows a tile (X, padded, and the most and mean
               a tile needs) and the share of (16-row, tap) pairs the
               kernel multiplies; at every routed (level, Cin, Cout) and at
               one 5^3 case (K = 125, L0, 32 -> 32) the kernel against its
               plain version, the plain version over JAX's plan and the
               gather conv (within 1e-3), the wrapper's and the launch's
               median ms over 20 calls, the plain version's over 5, the
               bound, the shared memory a block takes and B1's ms from
               phase 3 beside B2's; the launches must equal the calls;
7. kernel_bwd -- B1's backward (dx: the same kernel on the masked dy with W
               flipped and transposed; dW: the plain re-gather) through its
               autograd Function against the plain backward, at the routed
               shapes of a full-size training batch: error, the dx kernel's
               median ms over 20 launches, its host time per call, plain
               ms, bound, the slot and (tile, tap) shares as in phase 3,
               and the dW re-gather's ms beside its bound;
8. train    -- stage-1 training end to end: pq3d_tpu_torch.run builds the
               trainer (instseg_sceneverse + pallas_conv: true, batch 4 of
               synthetic 70k-point scenes, AdamW); 1 warm step, 5 timed
               steps (loss, grad norm, host-pipeline s, device ms per step;
               steps/s, scenes/s, peak memory; B1's forward and backward
               launches, which must be 2 x routed convs per step), then 5
               steps on one batch, whose loss (train mode, dropout off,
               read before and after them) must fall;
9. train_check -- one train step (dropout off) with B1 against the same
               step all-plain (loss) and with every backward on its plain
               version (routed-conv weight gradients), and each routed conv
               replayed at the step's own x and dy against its plain
               backward, all within 2e-2;
10. unified -- stage-2 serving end to end: the full-width
               unified_tasks_sceneverse model (PointNet++ on 80 objects x
               1024 points, the CLIP-large text tower, the mixed query
               decoder, the grounding head, T5-small greedy decode of 50
               tokens; random weights from a seed) behind
               UnifiedServer(batch_size=8) answers 64 requests that cycle
               through SyntheticRefer, SyntheticQA and SyntheticCaption
               (scenes of 50,000 points, 32 instances; TXT and LOC
               prompts): scenes/s, p50/p99, the server's stage seconds,
               peak memory, the device-clock ms (CUDA-event spans around
               each module, median of 3 forwards of one batch) of
               PointNet++, the CLIP tower, the query decoder and the
               decode; gates: every request
               resolves, ground_obj is a valid object with a finite score,
               tokens are EOS-frozen (also on one batch decoded with the
               EOS logit raised until some row emits it early, since
               random weights do not), on one batch the card's
               ground_logits and teacher-forced generation logits agree
               with the same model on the CPU (f32, TF32 off) within 1e-4
               relative while the same batch with TF32 on (the control,
               printed) does not, and the greedy tokens are equal or
               differ first where the CPU's top-2 logit margin is below
               1e-4; B1 and B2 are on no stage-2 path (their launches
               here are printed);
11. unified_train -- stage-2 training end to end: the trainer that
               pq3d_tpu_torch.run builds (build_multitask_trainer) for
               unified_tasks_sceneverse at its widths and batch (128) on
               SyntheticRefer, SyntheticQA and SyntheticCaption (scenes of
               50,000 points, 32 instances; warmup set to 0); one epoch of
               6 steps (1 warm, 5 timed) with the loaders in process
               (num_workers=0), then one with one spawn pool of
               min(8, cpu_count - 1) workers: per step the loss parts, the
               gradient norm, the host pipeline's seconds and the device
               ms of forward, loss, backward and optimizer (CUDA events);
               steps/s, items/s, peak memory; gates: finite losses, the
               generation head's AdamW groups at 1e-5 beside 1e-4, B1 and
               B2 launched 0 times, one batch's loss (every dropout and
               memory dropout off) falls over 5 steps on it; one step at
               batch 4 on the card against a deep copy on the CPU (f32,
               TF32 off: loss parts within 1e-5, gradient norm 1e-4, all
               gradients together within 1e-3 in L2, every updated
               parameter within 2.1 x the rate; the updates' L2 printed)
               and a TF32 control that must exceed a gate; then
               every val set evaluated (132 items each,
               the last batch wrap-padded to 128), every item scored once;
12. recipe -- the JAX package's two-stage recipe (tools/dress_rehearsal.py)
               on files in the SceneVerse layout: write_replica writes 8 + 2
               scans at real-scan statistics (150,000 points, 28 objects
               plus wall, floor and ceiling, 8 annotations a task a scan;
               seconds, bytes, voxels, segments and instances a scan);
               through pq3d_tpu_torch.run: stage 1 (instseg_sceneverse,
               pallas_conv: true, offline segment features) for one epoch
               at batch 4 with the official-protocol eval at full
               resolution, its resume for a second epoch, the GT-query
               variant (instseg_sceneverse_gt) for 2 steps, and stage 2
               (unified_tasks_sceneverse at its widths, batch 8, the seven
               SceneVerse datasets with predicted objects) warm-started from
               stage 1's checkpoint for one epoch with every dataset's
               evaluator; per run the seconds, steps/s, host-pipeline
               seconds a batch, peak memory and B1's launches, which must
               equal the routed convs of every forward (forward) and of
               every train forward (dx); gates: finite metrics, no metric
               lost across the resume, every GT batch with its offline
               mask, a finite direct loss, train_check (phase 9) on a GT
               batch, the warm start loading RECIPE_WARM_START_LOADED
               tensors, finite metrics of all seven datasets; B1 against its
               plain version at the routed shapes of 4 replica scans, with
               its ms a forward beside phase 3's;
then a summary line (B1 against B2 in this run), one JSON line with every
hand kernel's numbers, and the result line.

    python3 chip_smoke.py --profile PATH

adds torch.profiler traces of one served forward (after phase 5), of one
train step (after phase 9), of one unified batch (forward and decode,
phase 10) and of one unified train step (phase 11): device busy time
against the host clock, the idle share and the device time by kernel (the
top rows printed, the whole tables written to PATH and to PATH with
``_train``, ``_unified`` and ``_unified_train`` before its extension).
"""
import argparse
import contextlib
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


def host_time(fn, reps):
    """Host milliseconds per call of ``fn`` over ``reps`` calls back to
    back, the device left to run behind them: what a call costs the host
    (its checks, casts, launches), not the device."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


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


def zrun_plan_bytes(n, with_valid):
    """Bytes of the z-run plan (zbase int32, zcode int8) and the mask."""
    return n * 9 * 4 + n * 27 + (n if with_valid else 0)


def tap_shares(zrun_conv, zc):
    """(slots, staged, multiplied): the share of the N x 27 slots that
    hold a reference, and of the (tile, tap) pairs B1 stages (its 128-row
    tiles) and multiplies (each warpgroup's 64 rows), from the plan."""
    slots = (zc != -2).sum().item() / (zc.shape[0] * 27)
    staged = zrun_conv.tile_tap_mask(zc, zrun_conv.TILE).float().mean().item()
    mult = zrun_conv.tile_tap_mask(zc, zrun_conv.MMA_ROWS).float().mean()
    return slots, staged, mult.item()


def ptxas_summary(log, kernel, scale=1):
    """'Cout: registers / spill bytes' of each instantiation of ``kernel``
    in the ptxas -v log of its build (the template argument times
    ``scale`` is the Cout it takes)."""
    import re
    out, cout = [], None
    for line in log.splitlines():
        m = re.search(kernel + r"ILi(\d+)E", line)
        if m and "Compiling entry" in line:
            cout = int(m.group(1)) * scale
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cout is not None:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cout is not None:
            out.append(f"{cout}: {m.group(1)} reg / {spill} B spill")
            cout = None
    return out


def conv_bound(n, cin, cout, pairs, plan_bytes, flops_peak, bw_peak,
               taps=27):
    """(bound ms, what bounds it, flops, bytes) of one sparse conv: the
    valid references' bf16 products over the tensor-core peak against
    reading x (f32), W (bf16) and the plan once and writing y (f32)."""
    flops = 2.0 * pairs * cin * cout
    nbytes = (n * cin * 4 + taps * cin * cout * 2 + plan_bytes
              + n * cout * 4)
    return bound_of(flops, nbytes, flops_peak, bw_peak) + (flops, nbytes)


def bound_of(flops, nbytes, flops_peak, bw_peak):
    """(the larger of the two times in ms, which of them it is)."""
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / bw_peak * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


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


@contextlib.contextmanager
def dropout_off(model):
    """Every dropout of ``model`` at rate 0 inside the block, memory
    dropout (the query decoder's) included."""
    import torch
    drops = [m for m in model.modules() if isinstance(m, torch.nn.Dropout)]
    rates = [m.p for m in drops]
    layers = [m for m in model.modules() if hasattr(m, "memory_dropout")]
    mem_rates = [m.memory_dropout for m in layers]
    for m in drops:
        m.p = 0.0
    for m in layers:
        m.memory_dropout = 0.0
    try:
        yield
    finally:
        for m, p in zip(drops, rates):
            m.p = p
        for m, p in zip(layers, mem_rates):
            m.memory_dropout = p


def batch_loss(trainer, b):
    """The loss of the device batch ``b`` in train mode (BatchNorm on the
    batch's own statistics) with dropout off, no gradient, no update."""
    import torch
    with dropout_off(trainer.model), torch.no_grad():
        trainer.model.train()
        total, _ = trainer.loss_fn(trainer.model(b), b)
    return total.item()


PLAN_KEYS = ("win_lo", "nbr_local", "exc_in_k", "exc_row_tile",
             "exc_src_tile")         # build_window_map's plan, as JAX's


def morton_maps(level_coords, pad, kernel):
    """The flat (B * pad, K) map of one level with each scene's voxels in
    Morton order (padding rows after them, scene s at rows s * pad ..),
    the valid rows and the host seconds of ``morton_order``."""
    import numpy as np
    from pq3d_tpu_torch.ops import kernel_maps
    parts, valid, morton_s = [], [], 0.0
    for s, c in enumerate(level_coords):
        t0 = time.time()
        order = kernel_maps.morton_order(c)
        morton_s += time.time() - t0
        nbr = kernel_maps.build_neighbor_map(c[order], kernel, n_pad=pad)
        parts.append(np.where(nbr >= 0, nbr + s * pad, -1).astype(np.int32))
        valid.append(np.arange(pad) < len(c))
    return np.concatenate(parts), np.concatenate(valid), morton_s


def winconv_phase(scenes, batch, pipe, shapes, b1_ms, dev, flops_peak,
                  bw_peak):
    """Kernel B2 (the windowed conv) at full width on the served batch's
    coordinates, Morton-ordered: for each level with routed convs, the
    plan at tile 256 / window 512, its fold into the kernel's plan and
    their host seconds; at each routed (level, Cin, Cout) and at one 5^3
    case (K = 125, L0, 32 -> 32) the kernel against its plain version, the
    plain version over JAX's plan and the gather conv (all within 1e-3),
    then the wrapper's and the launch's median ms over 20 calls, the plain
    version's over 5, the bound, the block's shared memory and B1's ms at
    the same shape.  Returns the level and shape records and the launch
    count of the phase."""
    import numpy as np
    import torch
    from pq3d_tpu_torch.ops import kernel_maps, voxelize, windowed_conv
    from pq3d_tpu_torch.ops.sparse import sparse_conv
    tile, window = 256, 512
    levels = sorted({lvl for lvl, _, _ in shapes})
    coords = []
    for i, s in enumerate(scenes):
        c = [voxelize.quantize(s["points"].astype(np.float32),
                               pipe.voxel_size)[0]]
        while len(c) <= max(levels):
            c.append(kernel_maps.downsample_coords(c[-1])[0])
        for lvl in levels:
            if len(c[lvl]) != int(batch["maps"][f"valid_{lvl}"][i].sum()):
                fail(f"scene {i} L{lvl}: rebuilt {len(c[lvl])} voxels, the "
                     f"served batch has "
                     f"{int(batch['maps'][f'valid_{lvl}'][i].sum())}")
        coords.append(c)
    gen = torch.Generator(device="cpu").manual_seed(3)
    windowed_conv.reset_counts()            # B2's path starts here
    calls = 0
    level_recs, recs = [], []
    cases = [(lvl, 3, cin, cout, shapes[(lvl, cin, cout)])
             for lvl, cin, cout in sorted(shapes)] + [(0, 5, 32, 32, 0)]
    plans = {}
    for lvl, kernel, cin, cout, per_fwd in cases:
        if (lvl, kernel) not in plans:
            plans.clear()
            pad = batch["maps"][f"valid_{lvl}"].shape[1]
            nbr, valid, morton_s = morton_maps([c[lvl] for c in coords], pad,
                                               kernel)
            t0 = time.time()
            plan = windowed_conv.build_window_map(nbr, tile, window)
            plan_s = time.time() - t0
            t0 = time.time()
            folded = windowed_conv.fold_exceptions(plan, nbr, tile, window)
            fold_s = time.time() - t0
            refs = int((nbr >= 0).sum())
            extra = (folded["exc_src"] >= 0).sum(1)
            k = nbr.shape[1]
            # the (16-row, tap) pairs some row references: what the
            # kernel's warps multiply
            mult = float((folded["nbr_slab"].reshape(-1, 16, k) >= 0)
                         .any(1).mean())
            lrec = {"level": lvl, "k": k, "n": nbr.shape[0],
                    "morton_s": morton_s, "window_map_s": plan_s,
                    "fold_s": fold_s, "references": refs,
                    "valid_slot_share": refs / nbr.size,
                    "exceptions": plan["n_exceptions"],
                    "out_of_window_share": plan["n_exceptions"] / refs,
                    "x_rows": folded["exc_src"].shape[1],
                    "x_max": int(extra.max()), "x_mean": float(extra.mean()),
                    "mult_share": mult,
                    "plan_bytes": sum(folded[key].nbytes
                                      for key in windowed_conv.FOLDED_KEYS)}
            level_recs.append(lrec)
            print(f"winconv: L{lvl} K={k} N={lrec['n']} Morton order "
                  f"{morton_s:.3f} s, window map {plan_s:.3f} s, fold "
                  f"{fold_s:.3f} s (host) | {plan['n_exceptions']} of {refs} "
                  f"references out of the window "
                  f"({lrec['out_of_window_share']:.4f}); "
                  f"{lrec['valid_slot_share']:.4f} of the N x K slots hold a "
                  f"reference | extra slab rows a tile: X {lrec['x_rows']} "
                  f"(most {lrec['x_max']}, mean {lrec['x_mean']:.1f}) | "
                  f"(16-row, tap) pairs multiplied {mult:.4f}", flush=True)
            plans[(lvl, kernel)] = (
                torch.from_numpy(nbr).to(dev), torch.from_numpy(valid).to(dev),
                {key: torch.from_numpy(plan[key]).to(dev)
                 for key in PLAN_KEYS},
                {key: torch.from_numpy(folded[key]).to(dev)
                 for key in windowed_conv.FOLDED_KEYS}, lrec)
        nbr_d, valid_d, plan_d, fold_d, lrec = plans[(lvl, kernel)]
        n, k = nbr_d.shape
        x = torch.randn(n, cin, generator=gen).to(dev) * valid_d[:, None]
        w = (torch.randn(k, cin, cout, generator=gen)
             * (2.0 / (k * cin)) ** 0.5).to(dev)

        def kernel_call():
            return windowed_conv.windowed_sparse_conv(
                x, w, *fold_d.values(), tile=tile, window=window)
        got = kernel_call()
        calls += 1
        ref = windowed_conv.windowed_sparse_conv_folded_reference(
            x, w, fold_d, tile, window)
        jref = windowed_conv.windowed_sparse_conv_reference(x, w, plan_d,
                                                            tile, window)
        gat = sparse_conv(x, nbr_d, w)
        torch.cuda.synchronize()
        errs = {"kernel_vs_plain": rel_err(got, ref),
                "kernel_vs_jax_plan": rel_err(got, jref),
                "kernel_vs_gather": rel_err(got, gat),
                "plain_vs_gather": rel_err(ref, gat)}
        if not (torch.isfinite(got).all().item()
                and max(errs.values()) <= 1e-3):
            fail(f"windowed_conv disagrees at L{lvl} K={k} {cin}->{cout}: "
                 f"{errs}")
        ms = cuda_time(kernel_call, 20)
        prep = windowed_conv.prepare(x, w, lrec["x_rows"], window)
        kernel_ms = cuda_time(lambda: windowed_conv.launch(
            *prep, *fold_d.values(), cout, tile, window), 20)
        calls += 40
        plain_ms = cuda_time(
            lambda: windowed_conv.windowed_sparse_conv_folded_reference(
                x, w, fold_d, tile, window), 5)
        ck, bufs, smem = windowed_conv.smem_fit(cin, cout, window,
                                                lrec["x_rows"], k)
        bound, by, flops, nbytes = conv_bound(
            n, cin, cout, lrec["references"], lrec["plan_bytes"], flops_peak,
            bw_peak, taps=k)
        b1 = b1_ms.get((lvl, cin, cout)) if k == 27 else None
        dense = 2.0 * n * k * cin * cout
        rec = {"level": lvl, "k": k, "n": n, "cin": cin, "cout": cout,
               "per_forward": per_fwd, "ms": ms, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "dense_flops": dense,
               "mult_share": lrec["mult_share"],
               "mult_flops": lrec["mult_share"] * dense, "bound_ms": bound,
               "bound_by": by, "b1_ms": b1, "flops": flops, "bytes": nbytes,
               "smem_bytes": smem, "ck": ck, "slab_buffers": bufs,
               "max_abs_err": (got - ref).abs().max().item(), **errs}
        recs.append(rec)
        b1_txt = f"B1 zrun_conv {b1:.3f} ms" if b1 is not None else \
            "B1 does not take this shape"
        print(f"winconv: windowed_conv L{lvl} K={k} N={n} {cin}->{cout} "
              f"({per_fwd} per forward) rel_err vs plain "
              f"{errs['kernel_vs_plain']:.2e}, vs JAX's plan "
              f"{errs['kernel_vs_jax_plan']:.2e}, vs gather conv "
              f"{errs['kernel_vs_gather']:.2e} | {ms:.3f} ms (kernel alone "
              f"{kernel_ms:.3f} ms; plain {plain_ms:.3f} ms; bound "
              f"{bound:.4f} ms by {by}; {flops / ms / 1e9:.1f} TFLOP/s on the "
              f"references, kernel {dense / kernel_ms / 1e9:.1f} on all N x K "
              f"slots, {rec['mult_flops'] / kernel_ms / 1e9:.1f} on the "
              f"multiplied pairs) | shared memory {smem} B a block (chunk "
              f"{ck}, {bufs} slab buffer{'s' if bufs > 1 else ''}) | {b1_txt}",
              flush=True)
        del x, w, got, ref, jref, gat, prep
    launches = windowed_conv.launches        # B2's path ends here
    if launches != calls:
        fail(f"windowed_conv launched {launches} times for {calls} calls")
    del plans
    torch.cuda.empty_cache()
    return {"levels": level_recs, "shapes": recs, "launches": launches}


def b1_shapes(zrun_conv, fm, routed, dev, flops_peak, bw_peak, label):
    """B1 against its plain version (f32 and bf16 x, within 1e-2 of
    max|ref|) at each routed (level, Cin, Cout) of one forward over the
    flat maps ``fm``, on random x and W: its median ms over 20 launches,
    the wrapper's host ms per call, the plain version's ms, the bound and
    the slot and (tile, tap) shares.  Returns a record per shape."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(0)
    shapes = {}          # (level, cin, cout) -> routed convs per forward
    for _, lvl, cin, cout in routed:
        shapes[(lvl, cin, cout)] = shapes.get((lvl, cin, cout), 0) + 1
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
                host_ms = host_time(lambda: zrun_conv.zrun_conv(
                    xd, w, zb, zc, valid), 20)
                plain_ms = cuda_time(lambda: zrun_conv.zrun_conv_reference(
                    xd, w, zb, zc, valid), 5)
                pairs = int((zc != -2).sum().item())
                bound, by, flops, nbytes = conv_bound(
                    n, cin, cout, pairs, zrun_plan_bytes(n, True),
                    flops_peak, bw_peak)
                slots, staged, mult = tap_shares(zrun_conv, zc)
                rec = {"level": lvl, "n": n, "cin": cin, "cout": cout,
                       "per_forward": per_fwd, "ms": ms,
                       "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": by, "flops": flops, "dense27_flops":
                           2.0 * n * 27 * cin * cout, "bytes": nbytes,
                       "slot_share": slots, "tile_tap_share": staged,
                       "mult_share": mult,
                       "mult_flops": mult * 2.0 * n * 27 * cin * cout}
            rec[f"max_abs_err_{'f32' if dt is torch.float32 else 'bf16'}"] \
                = diff
            rec[f"max_rel_err_{'f32' if dt is torch.float32 else 'bf16'}"] \
                = rel
        per_shape.append(rec)
        print(f"{label}: zrun_conv L{lvl} N={n} {cin}->{cout} "
              f"rel_err f32 {rec['max_rel_err_f32']:.2e} "
              f"bf16 {rec['max_rel_err_bf16']:.2e} | {rec['ms']:.3f} ms "
              f"(host {rec['host_ms']:.3f} ms a call, plain "
              f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f}"
              f" ms by {rec['bound_by']}, {rec['flops'] / rec['ms'] / 1e9:.1f}"
              f" TFLOP/s on valid taps, "
              f"{rec['mult_flops'] / rec['ms'] / 1e9:.1f} on multiplied "
              f"tiles) | slots {rec['slot_share']:.4f}, (tile, tap) pairs "
              f"staged {rec['tile_tap_share']:.4f}, multiplied "
              f"{rec['mult_share']:.4f}", flush=True)
        del x, w, zb, zc
    return per_shape


def kernel_bwd_phase(zrun_conv, fm, shapes, dev, flops_peak, bw_peak):
    """The kernel's backward at each routed shape: dx and dW through the
    autograd Function against the plain backward, then the dx kernel's
    median ms over 20 launches, its host time per call, its plain
    version's, its bound (Cin and Cout swapped: dy in, dx out) and the dW
    re-gather's ms."""
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
        host_ms = host_time(lambda: zrun_conv.zrun_conv(dym, wt, zb, zc,
                                                        phase="bwd"), 20)
        plain_ms = cuda_time(lambda: zrun_conv.zrun_conv_reference(
            dym, wt, zb, zc), 5)
        dw_ms = cuda_time(lambda: zrun_conv.zrun_weight_grad(x, zb, zc, dym),
                          5)
        pairs = int((zc != -2).sum().item())
        bound, by, flops, nbytes = conv_bound(
            n, cout, cin, pairs, zrun_plan_bytes(n, False), flops_peak,
            bw_peak)
        slots, staged, mult = tap_shares(zrun_conv, zc)
        # dW = sum over taps of x_tap^T @ dy: the same products, reading x
        # (f32), dy (f32) and the plan once and writing dW (f32)
        dw_bound, dw_by = bound_of(
            flops, n * cin * 4 + n * cout * 4 + zrun_plan_bytes(n, False)
            + 27 * cin * cout * 4, flops_peak, bw_peak)
        rec = {"level": lvl, "n": n, "cin": cout, "cout": cin,
               "forward": f"{cin}->{cout}", "per_step": per_step, "ms": ms,
               "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "dw_ms": dw_ms, "dw_bound_ms": dw_bound, "dw_bound_by": dw_by,
               "flops": flops, "bytes": nbytes, "slot_share": slots,
               "tile_tap_share": staged, "mult_share": mult,
               "mult_flops": mult * 2.0 * n * 27 * cin * cout,
               "max_abs_err_dx": (xg.grad - dx_ref).abs().max().item(),
               "max_rel_err_dx": rel_dx, "max_rel_err_dw": rel_dw}
        recs.append(rec)
        print(f"kernel_bwd: zrun_conv dx L{lvl} N={n} {cout}->{cin} "
              f"(forward {cin}->{cout}, {per_step} per step) rel_err dx "
              f"{rel_dx:.2e} dW {rel_dw:.2e} | {ms:.3f} ms (host "
              f"{host_ms:.3f} ms a call, plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms by {by}, "
              f"{flops / ms / 1e9:.1f} TFLOP/s on valid taps, "
              f"{rec['mult_flops'] / ms / 1e9:.1f} on multiplied tiles) | "
              f"slots {slots:.4f}, (tile, tap) pairs staged {staged:.4f}, "
              f"multiplied {mult:.4f} | dW re-gather {dw_ms:.3f} ms (bound "
              f"{dw_bound:.4f} ms by {dw_by})", flush=True)
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

    # the gate reads the batch's loss with dropout off before and after the
    # 5 steps: each step's own loss carries dropout's noise (+-3 around a
    # fall of 6-9 over the 5 steps), enough to decide a first-vs-last test
    wb = trainer._put(warm)
    before = batch_loss(trainer, wb)
    losses = [float(trainer.train_batch(warm)["loss"]) for _ in range(5)]
    after = batch_loss(trainer, wb)
    print(f"train: 5 steps on one batch, loss {losses} (dropout on); "
          f"dropout off {before:.4f} before, {after:.4f} after", flush=True)
    if not after < before:
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

    with dropout_off(model):
        runs = {mode: step(mode) for mode in ("K", "KP", "P", "K2")}
    backbone.pallas_conv = True
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


UNIFIED_REQUESTS = 64    # 8 batches of 8
# card against the CPU, max|diff| / max|ref|: between the f32 reading
# (about 3e-6) and the TF32 control's (about 7e-4 to 1.4e-3) on an H100
UNIFIED_GATE = 1e-4
MARGIN_GATE = 1e-4       # CPU top-2 logit margin where tokens may differ
EOS_SCALES = (1.5, 3.0, 6.0, 12.0, 24.0)   # EOS embedding row, after x0.1


def eos_frozen(toks, n_tokens):
    """The step of each row's first EOS (None where there is none); fails
    unless every token after it is PAD."""
    import numpy as np
    from pq3d_tpu_torch.models.t5 import T5_EOS_ID, T5_PAD_ID
    firsts = []
    for row in toks:
        if row.shape != (n_tokens,):
            fail(f"generation tokens of shape {row.shape}")
        eos = np.flatnonzero(row == T5_EOS_ID)
        if len(eos) and (row[eos[0] + 1:] != T5_PAD_ID).any():
            fail("tokens after the first EOS are not all PAD")
        firsts.append(int(eos[0]) if len(eos) else None)
    return firsts


def eos_biased_decode(model, b, n_tokens):
    """Greedy decode of batch ``b`` with T5's embedding (tied to the
    logits) scaled by 0.1 and its EOS row by each of ``EOS_SCALES`` in turn,
    until some row emits EOS before its last step: random weights never
    emit it at full width, so this is what exercises the EOS freeze on the
    card.  The embedding is restored after.  Returns the scale and each
    row's first EOS step."""
    import torch
    from pq3d_tpu_torch.models.t5 import T5_EOS_ID
    emb = model.generation_head.decoder.embed.weight
    saved = emb.detach().clone()
    try:
        for scale in EOS_SCALES:
            with torch.no_grad():
                emb.copy_(saved * 0.1)
                emb[T5_EOS_ID] *= scale
            with torch.inference_mode():
                toks = model(b)["generation_tokens"].cpu().numpy()
            firsts = eos_frozen(toks, n_tokens)
            if any(f is not None and f < n_tokens - 1 for f in firsts):
                return scale, firsts
    finally:
        with torch.no_grad():
            emb.copy_(saved)
    fail(f"no row emitted EOS before its last step at EOS scales "
         f"{EOS_SCALES}: the EOS freeze was not exercised")


def unified_requests(n, seed):
    """``n`` (scene, lang) requests cycling through the three synthetic
    unified datasets: scenes of 50,000 points and 32 instances."""
    from pq3d_tpu_torch.data import unified_datasets as uds
    cfg = {"data": {"synthetic": {"num_train": n, "n_points": 50_000,
                                  "n_instances": 32}}}
    sets = [uds.SyntheticRefer(cfg, "train"), uds.SyntheticQA(cfg, "train"),
            uds.SyntheticCaption(cfg, "train")]
    return [sets[i % 3].get_item(seed * 1000 + i) for i in range(n)]


def part_times(model, b, reps=3):
    """Device ms of PointNet++, the CLIP tower, the query decoder and the
    greedy decode inside one forward of batch ``b`` (CUDA events recorded
    by hooks around each module; median of ``reps`` forwards)."""
    import torch
    parts = {"pointnet": model.pc_encoder.backbone,
             "clip_tower": model.txt_encoder.tower,
             "query_decoder": model.unified_encoder,
             "decode": model.generation_head}
    events = {k: [] for k in parts}
    hooks = []

    def record(name, opening):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            if opening:
                events[name].append([ev])
            else:
                events[name][-1].append(ev)
        return hook
    for name, mod in parts.items():
        hooks.append(mod.register_forward_pre_hook(record(name, True)))
        hooks.append(mod.register_forward_hook(record(name, False)))
    try:
        forward_ms = []
        for _ in range(reps):
            forward_ms.append(cuda_time(lambda: model(b), 1))
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    out = {k: sorted(a.elapsed_time(e) for a, e in v)[len(v) // 2]
           for k, v in events.items()}
    out["forward"] = sorted(forward_ms)[len(forward_ms) // 2]
    return out


def unified_phase(card, dev, profile):
    """Stage-2 serving at full width through UnifiedServer; returns the
    phase's numbers."""
    import copy
    import numpy as np
    import torch
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.data import unified_datasets as uds
    from pq3d_tpu_torch.data.unified_pipeline import (UnifiedPipelineConfig,
                                                      collate_unified,
                                                      process_item)
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.models.t5 import T5_PAD_ID
    from pq3d_tpu_torch.ops import windowed_conv, zrun_conv
    from pq3d_tpu_torch.serve import UnifiedServer, to_device

    # f32 matmuls in f32 on the card: the CPU gate below measures the
    # port, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config("unified_tasks_sceneverse")
    pipe = UnifiedPipelineConfig(**cfg["data"]["unified_options"])
    n_tokens = cfg["model"]["generation_head"]["args"]["max_new_tokens"]
    feature_dims = {"mv": 768, "voxel": 128}
    import threading
    alive = [t.name for t in threading.enumerate()]
    print(f"unified: {len(alive)} Python threads alive at the phase's start "
          f"({', '.join(alive)}); torch intra-op threads "
          f"{torch.get_num_threads()}", flush=True)
    t0 = time.time()
    model = build_model(cfg, device="cuda", seed=0)
    print(f"unified: model built in {time.time() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"params | pipeline {pipe}", flush=True)
    b1_before, b2_before = zrun_conv.launches, windowed_conv.launches
    srv = UnifiedServer(model, pipe, batch_size=8,
                        feature_dims=feature_dims, max_delay_s=0.02,
                        detokenize=uds.detokenize, device="cuda")
    try:
        for f in [srv.submit(r) for r in unified_requests(8, seed=1)]:
            f.result(timeout=900)
        settle(srv, 8)
        srv.stats = type(srv.stats)()
        reqs = unified_requests(UNIFIED_REQUESTS, seed=2)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        results = [f.result(timeout=900)
                   for f in [srv.submit(r) for r in reqs]]
        wall = time.time() - t0
        settle(srv, len(reqs))
    finally:
        srv.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = srv.stats.summary()
    n_valid = [min(len(scene["inst_labels"]), pipe.max_obj_len)
               for scene, _ in reqs]
    eos_rows = 0
    for r, n in zip(results, n_valid):
        if not isinstance(r, dict) or r.get("ground_obj") is None:
            fail("a unified request did not resolve to an answer")
        g = r["ground_obj"]
        if not (0 <= g < n and np.isfinite(r["ground_scores"][g])):
            fail(f"ground_obj {g} is not a valid object of {n} with a "
                 f"finite score")
        if eos_frozen([np.asarray(r["generation_tokens"])],
                      n_tokens)[0] is not None:
            eos_rows += 1
    stages = " ".join(f"{k}={v:.3f}s" for k, v in sorted(
        st["stage_s"].items()))
    print(f"unified: {st['scenes']} requests in {st['steps']} batches of 8 "
          f"| {st['scenes_per_sec']:.3f} scenes/s (wall {wall:.2f} s) p50 "
          f"{st['p50_latency_s'] * 1e3:.1f} ms p99 "
          f"{st['p99_latency_s'] * 1e3:.1f} ms | {stages} | "
          f"max_memory_allocated {peak:.2f} GiB | rows with EOS "
          f"{eos_rows} of {len(reqs)} | ({card})", flush=True)

    # one batch (with its responses) on the card and on the CPU
    rng = np.random.default_rng(5)
    items = [process_item(s, l, pipe, rng, False, feature_dims)
             for s, l in reqs[:8]]
    np_batch = collate_unified([{k: v for k, v in it.items()
                                 if not k.startswith("meta_")}
                                for it in items], pipe, feature_dims,
                               train=False)
    np_batch.pop("obj_fts")
    b = to_device(np_batch, dev)
    serve_b = {k: v for k, v in b.items() if k != "response"}
    with torch.inference_mode():
        parts = part_times(model, serve_b)
    print("unified: device-clock ms on one batch of 8 (CUDA-event spans "
          "around each module, waits for the host's launches included; "
          "median of 3) "
          + " ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f" ({card})", flush=True)
    with torch.inference_mode():
        got = model(b)
    cpu_model = copy.deepcopy(model).cpu()
    t0 = time.time()
    with torch.inference_mode():
        ref = cpu_model(to_device(np_batch, torch.device("cpu")))
        valid = b["query_pad_masks"].cpu()
        ground_rel = rel_err(got["ground_logits"].cpu()[valid],
                             ref["ground_logits"][valid])
        gen_rel = rel_err(got["generation_logits"].cpu(),
                          ref["generation_logits"])
        toks_gpu = got["generation_tokens"].cpu()
        toks_cpu = ref["generation_tokens"]
        # the CPU decode's logits at every step: its own tokens fed back,
        # every position attended, as the decode loop does
        head = cpu_model.generation_head
        enc = head.LayerNorm_0(head.input_proj(ref["query"]))
        prev = torch.nn.functional.pad(toks_cpu[:, :-1].long(), (1, 0),
                                       value=T5_PAD_ID)
        step_logits = head.decoder(prev, enc, valid)
    cpu_s = time.time() - t0
    top2 = step_logits.topk(2, dim=-1).values
    margins = top2[..., 0] - top2[..., 1]                 # (B, steps)
    differ = (toks_gpu != toks_cpu)
    first_margin = None
    if differ.any():
        rows, steps = torch.nonzero(differ, as_tuple=True)
        first = {}
        for r_, s_ in zip(rows.tolist(), steps.tolist()):
            first.setdefault(r_, s_)
        first_margin = max(margins[r_, s_].item()
                           for r_, s_ in first.items())
    print(f"unified: card vs CPU (f32, TF32 off) on one batch: "
          f"ground_logits rel {ground_rel:.3e}, teacher-forced generation "
          f"logits rel {gen_rel:.3e} (gate {UNIFIED_GATE:g}) | greedy "
          f"tokens {'equal' if first_margin is None else 'differ'}"
          + ("" if first_margin is None else
             f", CPU top-2 margin at the first differing step "
             f"{first_margin:.3e} (gate {MARGIN_GATE:g})")
          + f" | smallest CPU top-2 margin over all steps "
          f"{margins.min().item():.3e} | CPU forward {cpu_s:.1f} s",
          flush=True)
    # control: the same batch with f32 matmuls in TF32, against the same
    # CPU reference, so the gate's distance from both readings is on record
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            got32 = model(b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ground_rel32 = rel_err(got32["ground_logits"].cpu()[valid],
                           ref["ground_logits"][valid])
    gen_rel32 = rel_err(got32["generation_logits"].cpu(),
                        ref["generation_logits"])
    print(f"unified: TF32 control (the same batch, TF32 on) against the "
          f"CPU: ground_logits rel {ground_rel32:.3e}, teacher-forced "
          f"generation logits rel {gen_rel32:.3e} (gate {UNIFIED_GATE:g})",
          flush=True)
    scale, firsts = eos_biased_decode(model, serve_b, n_tokens)
    print(f"unified: EOS freeze on the card (one batch, T5 embedding x0.1, "
          f"EOS row x{scale:g}): first EOS at steps "
          f"{[f if f is not None else '-' for f in firsts]} of {n_tokens}, "
          f"only PAD after it", flush=True)
    b1 = zrun_conv.launches - b1_before
    b2 = windowed_conv.launches - b2_before
    print(f"unified: launches of B1 {b1} and B2 {b2} (neither is on the "
          f"stage-2 path)", flush=True)
    if not (ground_rel <= UNIFIED_GATE and gen_rel <= UNIFIED_GATE):
        fail("the card's unified forward disagrees with the CPU's")
    if ground_rel32 <= UNIFIED_GATE and gen_rel32 <= UNIFIED_GATE:
        fail("the TF32 control passes the card-against-CPU gate: the gate "
             "would not catch f32 matmuls run in TF32")
    if first_margin is not None and first_margin >= MARGIN_GATE:
        fail(f"greedy tokens differ where the CPU's top-2 margin is "
             f"{first_margin:.3e}")
    if profile:
        stem, ext = os.path.splitext(profile)

        def unified_batch():
            with torch.inference_mode():
                model(serve_b)
        profile_run(unified_batch, "unified batch (forward and decode)",
                    f"{stem}_unified{ext}")
    return {"scenes_per_sec": st["scenes_per_sec"],
            "p50_s": st["p50_latency_s"], "p99_s": st["p99_latency_s"],
            "stage_s": st["stage_s"], "peak_gib": peak, "device_ms": parts,
            "ground_rel": ground_rel, "gen_rel": gen_rel,
            "ground_rel_tf32": ground_rel32, "gen_rel_tf32": gen_rel32,
            "eos_scale": scale, "tokens_equal": first_margin is None}


UNIFIED_TRAIN_ITEMS_VAL = 132   # one full eval batch of 128 and one of 4
# card against the CPU on one train step at batch 4 (f32, TF32 off),
# relative; four runs on an H100 80GB HBM3 at 700 W read: the loss parts
# at most 2.0e-7 (the TF32 control 8.8e-8 to 5.4e-5), the gradient norm
# 2.7e-6 to 9.4e-6 (3.3e-4 to 1.4e-3), all gradients together in L2
# 1.0e-5 to 2.9e-4 (1.0e-2 to 2.1e-2).  All updates together in L2 read
# 1.4e-4 to 1.6e-2 (1.0e-1 to 1.5e-1) and are not gated: AdamW's first
# step moves an element by up to the rate whatever the size of its
# gradient, so one element with a gradient near eps reads as a whole
# update; every element is held to 2.1 x the rate instead (one correct
# AdamW step moves it by at most lr * (1 + wd * |p|), |p| < 5 here)
UNIFIED_TRAIN_GATE = 1e-5    # the loss parts
UNIFIED_TRAIN_GATES = {"grad_norm": 1e-4, "gradients": 1e-3}
GRAD_NOISE = 1e-6   # a gradient below this share of the largest is f32 noise


def timed_train_run(trainer, loader, epoch, label, card):
    """One epoch of ``loader`` through ``trainer.train_epoch`` (its
    prefetching loader included), every step synchronised and split by
    CUDA events into forward, loss, backward and optimizer; the seconds
    each batch took to come out of the loader (in the prefetch thread).
    Step 1 is the warm step; steps 2-6 are timed."""
    import torch
    from pq3d_tpu_torch.train.state import make_train_step
    parts = ("forward", "loss", "backward", "optimizer")
    marks = []

    def mark(part):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1][part] = ev
    inner = make_train_step(trainer.model, trainer._optimizer,
                            trainer._scheduler, trainer.loss_fn,
                            trainer._grad_norm, mark=mark)
    steps, host_s = [], []

    def timed_step(batch):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        marks.append({"start": start})
        out = inner(batch)
        marks[-1]["optimizer"].synchronize()
        m = marks[-1]
        edges = ("start",) + parts
        steps.append({"end": time.time(),
                      **{p: m[a].elapsed_time(m[p])
                         for a, p in zip(edges, parts)},
                      **{k: float(v) for k, v in out.items()}})
        return out

    def timed_loader(ep):
        it = iter(loader(ep))
        while True:
            t = time.time()
            try:
                b = next(it)
            except StopIteration:
                return
            host_s.append(time.time() - t)
            yield b

    saved = trainer._train_step, trainer.train_data
    trainer._train_step, trainer.train_data = timed_step, timed_loader
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        trainer.train_epoch(epoch)
    finally:
        trainer._train_step, trainer.train_data = saved
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    bs = loader.loaders[0].batch_size
    for i, (s, h) in enumerate(zip(steps, host_s)):
        print(f"unified_train {label}: step {i + 1}{' (warm)' if i == 0 else ''}"
              f" loss {s['loss']:.4f} ground {s.get('ground_loss', 0):.4f} "
              f"generation {s.get('generation_loss', 0):.4f} grad_norm "
              f"{s['grad_norm']:.3f} | host pipeline {h:.3f} s | device ms "
              + " ".join(f"{p} {s[p]:.1f}" for p in parts)
              + f" = {sum(s[p] for p in parts):.1f}", flush=True)
    if len(steps) != 6:
        fail(f"unified_train {label}: the epoch ran {len(steps)} steps, "
             f"expected 6")
    if not all(math.isfinite(s[k]) for s in steps for k in s):
        fail(f"unified_train {label}: a loss or gradient norm is not finite")
    span = steps[-1]["end"] - steps[0]["end"]
    dev = {p: sorted(s[p] for s in steps[1:])[2] for p in parts}
    rec = {"steps_per_s": 5 / span, "items_per_s": 5 * bs / span,
           "wall_s": wall, "host_s": host_s,
           "host_s_timed_mean": sum(host_s[1:]) / 5,
           "device_ms_median": dev,
           "device_step_ms_median": sorted(
               sum(s[p] for p in parts) for s in steps[1:])[2],
           "peak_gib": peak / 2**30, "steps": steps}
    print(f"unified_train {label}: 5 timed steps (2-6) in {span:.2f} s: "
          f"{rec['steps_per_s']:.3f} steps/s, {rec['items_per_s']:.1f} "
          f"items/s at batch {bs} | host pipeline {rec['host_s_timed_mean']:.3f}"
          f" s a batch (steps 2-6; warm {host_s[0]:.3f}) | device ms a step "
          f"(median of 2-6) {rec['device_step_ms_median']:.1f}: "
          + " ".join(f"{p} {v:.1f}" for p, v in dev.items())
          + f" | epoch wall {wall:.2f} s | max_memory_allocated "
          f"{rec['peak_gib']:.2f} GiB | os.cpu_count() {os.cpu_count()} "
          f"({card})", flush=True)
    return rec


def unified_train_check(trainer, cfg, np_batch, total_steps):
    """One train step at batch 4 from the same weights on the card (TF32
    off, then TF32 on as the control) and on a deep copy of the model on
    the CPU, every dropout and memory dropout off.  Returns the readings
    of both card runs against the CPU ({tf32: readings}) and the CPU
    step's seconds."""
    import copy
    import torch
    from pq3d_tpu_torch.optim.optimizers import build_from_config
    from pq3d_tpu_torch.serve import to_device
    from pq3d_tpu_torch.train.state import make_train_step
    model = trainer.model
    model.unified_encoder.set_memory_generator(None)
    cpu_model = copy.deepcopy(model).cpu()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    old = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}

    def one_step(net, device):
        opt, sched, gn = build_from_config(cfg, net, total_steps)
        step = make_train_step(net, opt, sched, trainer.loss_fn, gn)
        with dropout_off(net):
            m = step(to_device(np_batch, device))
        if device.type == "cuda":
            torch.cuda.synchronize()
        return ({k: float(v) for k, v in m.items()},
                {n: p.grad.detach().cpu() for n, p in
                 net.named_parameters()},
                {n: p.detach().cpu() for n, p in net.named_parameters()})
    dev = next(model.parameters()).device
    card = {}
    for tf32 in (False, True):
        model.load_state_dict(start)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            card[tf32] = one_step(model, dev)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    model.unified_encoder.set_memory_generator(torch.Generator(
        device=dev).manual_seed(int(cfg.get("rng_seed", 42))))
    t0 = time.time()
    ref = one_step(cpu_model, torch.device("cpu"))
    cpu_s = time.time() - t0
    lr = float(cfg["solver"]["lr"])
    return ({k: step_readings(card[k], ref, old, lr) for k in card},
            cpu_s)


def step_readings(got, ref, old, lr):
    """One train step against a reference step from the same weights
    ``old``: (metrics, gradients, updated parameters) each.  Relative
    differences of the loss parts and the gradient norm; of all gradients
    together and of all updates (new minus old) together, in L2 (a single
    element whose gradient is near AdamW's eps moves its update by up to
    the rate, so per-tensor maxima say little); the per-tensor worst,
    max|diff| / max|ref|, beside them.  Tensors whose reference gradient is
    f32 noise (below ``GRAD_NOISE`` of the largest, but not 0) are left
    out and their largest update is reported in units of the rate."""
    metrics, grads, params = ref
    gmax = max(g.abs().max().item() for g in grads.values())
    noise = sorted(n for n, g in grads.items()
                   if 0 < g.abs().max().item() <= GRAD_NOISE * gmax)
    r = {k: abs(got[0][k] - v) / abs(v) for k, v in metrics.items() if v}
    sums = {"gradients": [0.0, 0.0], "updates": [0.0, 0.0]}
    worst = {"gradients": (0.0, ""), "updates": (0.0, "")}
    for n, g in grads.items():
        if n in noise:
            continue
        for key, a, b in (("gradients", got[1][n], g),
                          ("updates", got[2][n] - old[n],
                           params[n] - old[n])):
            a, b = a.double(), b.double()
            sums[key][0] += (a - b).square().sum().item()
            sums[key][1] += b.square().sum().item()
            den = b.abs().max().item()
            if den > 0 and (a - b).abs().max().item() / den > worst[key][0]:
                worst[key] = ((a - b).abs().max().item() / den, n)
    for key, (num, den) in sums.items():
        r[key] = math.sqrt(num / den)
    r["worst"] = worst
    r["noise"] = noise
    r["noise_update_over_lr"] = max(
        [(got[2][n] - old[n]).abs().max().item() / lr for n in noise]
        or [0.0])
    r["param_diff_over_lr"] = max(
        (got[2][n] - p).abs().max().item() / lr for n, p in params.items())
    return r


# tensors (parameters and BatchNorm statistics) of the full-width
# unified_tasks_sceneverse model that share name and shape with the
# instseg_sceneverse one: what the recipe's warm start must load
# (tests/test_torch_warm_start.py::test_published_warm_start_count)
RECIPE_WARM_START_LOADED = 200


def unified_train_phase(card, dev, profile):
    """Stage-2 training at full width through the trainer that
    ``python -m pq3d_tpu_torch.run`` builds; returns the phase's
    numbers."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from pq3d_tpu_torch import run
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.data.unified_loader import (MixedTaskLoader,
                                                    UnifiedTaskLoader)
    from pq3d_tpu_torch.data.unified_pipeline import (collate_unified,
                                                      process_item)
    from pq3d_tpu_torch.ops import windowed_conv, zrun_conv

    torch.backends.cuda.matmul.allow_tf32 = False
    # dropout draws from the global generators: seed them so the phase's
    # weights do not depend on what ran before it
    torch.manual_seed(0)
    t_phase = time.time()
    exp_dir = tempfile.mkdtemp(prefix="pq3d_unified_train_")
    bs = int(load_config("unified_tasks_sceneverse")["dataloader"]
             ["batchsize"])
    overrides = [
        "data.train=[SyntheticRefer,SyntheticQA,SyntheticCaption]",
        "data.synthetic.n_points=50000", "data.synthetic.n_instances=32",
        # two train batches a dataset: 6 steps an epoch, 1 warm + 5 timed
        f"data.synthetic.num_train={2 * bs}",
        f"data.synthetic.num_val={UNIFIED_TRAIN_ITEMS_VAL}",
        # the YAML's 5000-step warmup makes the first steps' updates vanish
        "solver.sched.args.warmup_steps=0",
        "log_every=1", "device=cuda", f"exp_dir={exp_dir}"]
    try:
        cfg = load_config("unified_tasks_sceneverse", overrides)
        print("unified_train: unified_tasks_sceneverse at its widths, batch "
              f"{cfg['dataloader']['batchsize']} (eval "
              f"{cfg['dataloader']['batchsize_eval']}), overrides: "
              + " ".join(overrides[:-1]), flush=True)
        t0 = time.time()
        trainer = run.build_multitask_trainer(cfg)
        trainer._lazy_init()
        model = trainer.model
        print(f"unified_train: trainer built in {time.time() - t0:.1f} s, "
              f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
              f"params", flush=True)
        groups = trainer._optimizer.param_groups
        gen_ids = {id(p) for p in model.generation_head.parameters()}
        gen = [g for g in groups if id(g["params"][0]) in gen_ids]
        rest = [g for g in groups if id(g["params"][0]) not in gen_ids]
        print("unified_train: AdamW groups (initial lr, weight decay, "
              "tensors): " + "; ".join(
                  f"{g['initial_lr']:g}, {g['weight_decay']:g}, "
                  f"{len(g['params'])}" for g in groups), flush=True)
        if not (len(gen) == 2 and all(
                all(id(p) in gen_ids for p in g["params"])
                and g["initial_lr"] == 1e-5 for g in gen)
                and all(g["initial_lr"] == 1e-4 for g in rest)):
            fail("the generation head's AdamW groups are not at 1e-5 beside "
                 "1e-4")

        zrun_conv.reset_counts()            # main path starts here
        windowed_conv.reset_counts()
        base = trainer.train_data
        runs = {"workers0": timed_train_run(trainer, base, 0, "workers=0",
                                            card)}
        nw = min(8, (os.cpu_count() or 2) - 1)
        pooled = MixedTaskLoader(
            [UnifiedTaskLoader(lo.dataset, lo.cfg, lo.batch_size, True,
                               seed=lo.seed, feature_dims=lo.feature_dims,
                               num_workers=nw) for lo in base.loaders],
            seed=base.seed)
        try:
            runs[f"workers{nw}"] = timed_train_run(
                trainer, pooled, 1, f"workers={nw}", card)
        finally:
            pooled.close()
        b1, b2 = zrun_conv.launches, windowed_conv.launches  # path ends
        lrs = [g["lr"] for g in groups]
        print(f"unified_train: rates after {trainer.step} steps: generation "
              f"head {gen[0]['lr']:.4e}, the rest {rest[0]['lr']:.4e} "
              f"(ratio {gen[0]['lr'] / rest[0]['lr']:.6f}) | launches of B1 "
              f"{b1} and B2 {b2} over both runs (neither is on the "
              f"stage-2 path)", flush=True)
        if abs(gen[0]["lr"] / rest[0]["lr"] - 0.1) > 1e-9 or b1 or b2 \
                or len(set(lrs)) != 2:
            fail("rates not at 1:10 after the steps, or a hand kernel ran on "
                 "the stage-2 training path")

        # learning: one QA batch's loss (ground and generation; train
        # mode, every dropout and memory dropout off) before and after 5
        # steps on it
        one = next(iter(base.loaders[1](99)))
        wb = trainer._put(one)
        before = batch_loss(trainer, wb)
        losses = [float(trainer.train_batch(one)["loss"]) for _ in range(5)]
        after = batch_loss(trainer, wb)
        print(f"unified_train: 5 steps on one batch, loss {losses} (dropout "
              f"and memory dropout on); both off {before:.4f} before, "
              f"{after:.4f} after", flush=True)
        if not after < before:
            fail("the unified loss did not fall over 5 steps on one batch")

        # card against the CPU, one train step at batch 4
        lo0 = base.loaders[0]
        sets = [lo.dataset for lo in base.loaders]
        rng = np.random.default_rng(7)
        items = [process_item(*sets[i % 3].get_item(i), lo0.cfg, rng, True,
                              lo0.feature_dims) for i in range(4)]
        np_batch = collate_unified(
            [{k: v for k, v in it.items() if not k.startswith("meta_")}
             for it in items], lo0.cfg, lo0.feature_dims, train=True)
        check, cpu_s = unified_train_check(trainer, cfg, np_batch,
                                           trainer._total_steps)
        f32, tf32 = check[False], check[True]
        keys = [k for k in f32 if k not in (
            "worst", "noise", "noise_update_over_lr", "param_diff_over_lr",
            "updates")]
        gates = {k: UNIFIED_TRAIN_GATES.get(k, UNIFIED_TRAIN_GATE)
                 for k in keys}
        print("unified_train: one step at batch 4, card (f32, TF32 off) vs "
              "CPU, relative: " + " ".join(
                  f"{k} {f32[k]:.3e} (gate {gates[k]:g})" for k in keys)
              + " | per-tensor worst, max|diff| / max|ref|: "
              + " ".join(f"{k} {v:.3e} {n}" for k, (v, n) in
                         f32["worst"].items())
              + f" | updates {f32['updates']:.3e} (not gated), updated "
              f"parameters at most {f32['param_diff_over_lr']:.3f} x lr "
              f"apart (gate 2.1) | TF32 control: " + " ".join(
                  f"{k} {tf32[k]:.3e}" for k in keys + ["updates"])
              + f" | f32-noise gradients {f32['noise']}: update "
              f"{f32['noise_update_over_lr']:.3f} x lr | CPU step "
              f"{cpu_s:.1f} s", flush=True)
        if any(f32[k] > gates[k] for k in keys) \
                or f32["noise_update_over_lr"] > 1.01 \
                or f32["param_diff_over_lr"] > 2.1:
            fail("the card's unified train step disagrees with the CPU's")
        if all(tf32[k] <= gates[k] for k in keys):
            fail("the TF32 control passes the train-step gates: they would "
                 "not catch f32 matmuls run in TF32")

        # evaluation of the three val sets, the last batch of each
        # wrap-padded (128 + 4 real rows)
        torch.cuda.synchronize()
        t0 = time.time()
        results = trainer.eval_epoch(0)
        torch.cuda.synchronize()
        eval_s = time.time() - t0
        counts = {name: ev.total_count for name, _, ev in trainer.val_sets}
        cap = [ev for _, _, ev in trainer.val_sets if hasattr(ev, "_items")]
        keys_scored = [len({it["key"] for it in ev._items}) for ev in cap]
        print(f"unified_train: eval of 3 x {UNIFIED_TRAIN_ITEMS_VAL} items "
              f"(the metrics: the [eval 0] line above) in {eval_s:.2f} s | "
              f"items scored {counts}, distinct caption keys {keys_scored} "
              f"| target_metric {results['target_metric']:.4f}",
              flush=True)
        if not all(math.isfinite(v) for v in results.values()) \
                or set(counts.values()) != {UNIFIED_TRAIN_ITEMS_VAL} \
                or keys_scored != [UNIFIED_TRAIN_ITEMS_VAL]:
            fail("an eval metric is not finite or an item was not scored "
                 "exactly once")
        if profile:
            stem, ext = os.path.splitext(profile)
            profile_run(lambda: trainer.train_batch(one),
                        "unified train step", f"{stem}_unified_train{ext}")
        trainer._close_loaders()
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    total = time.time() - t_phase
    print(f"unified_train: phase {total:.1f} s ({card})", flush=True)
    return {"runs": runs, "check": f32, "check_tf32": tf32, "cpu_s": cpu_s,
            "eval_s": eval_s, "loss_before": before, "loss_after": after,
            "phase_s": total}


RECIPE_SPEC = {"n_train": 8, "n_val": 2}   # real-scan statistics otherwise
RECIPE_GATE = 2e-2                         # train_check's


@contextlib.contextmanager
def patched(owner, name, wrap):
    """``owner.name`` replaced by ``wrap(original)`` inside the block."""
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def last_metrics(exp_dir, prefix):
    """The last value of each eval metric a run logged under a prefix that
    starts with ``prefix`` (``val`` for stage 1, ``val-<dataset>`` for
    stage 2), keyed ``prefix/name``."""
    out = {}
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            p = str(rec.get("prefix", ""))
            if p.startswith(prefix):
                out.update({f"{p}/{k}": v for k, v in rec.items()
                            if k not in ("step", "time", "prefix")})
    return out


def all_finite(metrics):
    return bool(metrics) and all(
        isinstance(v, (int, float)) and math.isfinite(v)
        for v in metrics.values())


def recipe_stage(label, argv, zrun_conv, stage1, card):
    """One ``python -m pq3d_tpu_torch.run`` call in this process, with the
    B1 counts set to 0 just before it and read just after.  Records each
    batch's host-pipeline seconds (and the first train batch), each model
    forward's mode and routed convs (stage 1), each epoch's metrics and
    the peak memory; restores the signal handlers the trainer installs."""
    import signal
    import torch
    from pq3d_tpu_torch import run
    from pq3d_tpu_torch.data import datasets, unified_loader
    from pq3d_tpu_torch.models.query3d import Query3DUnified
    from pq3d_tpu_torch.train.trainer import Query3DTrainer
    rec = {"host": [], "forwards": [], "epochs": [], "first": None,
           "offline_mask": []}

    def assembler(orig):
        def timed(*args):
            t = time.time()
            batch = orig(*args)
            train = bool(args[5])
            rec["host"].append((train, time.time() - t))
            if train:
                rec["offline_mask"].append("offline_attn_mask" in batch)
                if rec["first"] is None:
                    rec["first"] = batch
            return batch
        return timed

    def forward(orig):
        def counted(self, batch):
            if stage1:
                rec["forwards"].append((self.training, len(
                    self.voxel_encoder.backbone.routed_convs(
                        level_rows(batch)))))
            return orig(self, batch)
        return counted

    def epoch(orig):
        def recorded(self, e):
            out = orig(self, e)
            rec["epochs"].append(out)
            return out
        return recorded

    owner = (datasets, "_assemble_instseg_batch") if stage1 else \
        (unified_loader, "_assemble_unified_batch")
    handlers = {s: signal.getsignal(s) for s in (signal.SIGUSR1,
                                                 signal.SIGTERM)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zrun_conv.reset_counts()                   # this path starts here
    t0 = time.time()
    try:
        with patched(*owner, assembler), \
                patched(Query3DUnified, "forward", forward), \
                patched(Query3DTrainer, "train_epoch", epoch):
            trainer = run.main(argv)
        torch.cuda.synchronize()
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)
    rec["wall_s"] = time.time() - t0
    rec["counts"] = dict(zrun_conv.phase_launches)   # and ends here
    rec["peak"] = torch.cuda.max_memory_allocated()
    steps = sum(int(e["batches"]) for e in rec["epochs"])
    epoch_s = sum(e["epoch_time_s"] for e in rec["epochs"])
    host_train = [h for tr, h in rec["host"] if tr]
    host_eval = [h for tr, h in rec["host"] if not tr]
    rec.update(steps=steps, epoch_s=epoch_s,
               steps_per_s=steps / max(epoch_s, 1e-9),
               host_train_s=sum(host_train) / max(len(host_train), 1),
               host_eval_s=sum(host_eval) / max(len(host_eval), 1))
    train_routed = [n for tr, n in rec["forwards"] if tr]
    eval_routed = [n for tr, n in rec["forwards"] if not tr]
    rec.update(train_routed=train_routed, eval_routed=eval_routed)
    print(f"recipe: {label}: {rec['wall_s']:.1f} s in all, {steps} steps "
          f"in {epoch_s:.2f} s ({rec['steps_per_s']:.3f} steps/s), host "
          f"pipeline {rec['host_train_s']:.3f} s a train batch "
          f"({len(host_train)}), {rec['host_eval_s']:.3f} s an eval batch "
          f"({len(host_eval)}) | max_memory_allocated "
          f"{rec['peak'] / 2**30:.2f} GiB | zrun_conv launches fwd "
          f"{rec['counts']['fwd']} bwd {rec['counts']['bwd']}, routed "
          f"convs per train forward {train_routed}, per eval forward "
          f"{eval_routed} ({card})", flush=True)
    if stage1:
        if len(train_routed) != steps or not all(train_routed):
            fail(f"{label}: {len(train_routed)} train forwards with "
                 f"routed convs {train_routed} for {steps} steps")
        # forward: every forward's routed convs; dx: the train steps'
        if rec["counts"]["fwd"] != sum(train_routed) + sum(eval_routed) \
                or rec["counts"]["bwd"] != sum(train_routed):
            fail(f"{label}: zrun_conv launches fwd {rec['counts']['fwd']} "
                 f"bwd {rec['counts']['bwd']} against routed convs "
                 f"{train_routed} (train) and {eval_routed} (eval)")
    elif rec["counts"]["fwd"] or rec["counts"]["bwd"]:
        fail(f"{label}: zrun_conv ran on the stage-2 path")
    return trainer, rec


def recipe_phase(card, dev, zrun_conv, synth_ms, flops_peak, bw_peak):
    """The JAX package's two-stage recipe (tools/dress_rehearsal.py) on a
    SceneVerse-layout replica at real-scan statistics, through
    ``python -m pq3d_tpu_torch.run``; returns the phase's numbers."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from pq3d_tpu_torch.data.datasets import SceneVerseInstSeg, load_pth
    from pq3d_tpu_torch.data.instseg_pipeline import (make_batch,
                                                      pipeline_config)
    from pq3d_tpu_torch.data.replica import ReplicaSpec, write_replica
    from pq3d_tpu_torch.models.sparse_unet import flatten_maps
    from pq3d_tpu_torch.ops.voxelize import quantize
    from pq3d_tpu_torch.serve import to_device

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="pq3d_recipe_")
    base, pred, aux = (os.path.join(root, d) for d in ("base", "pred",
                                                        "aux"))
    out = {}
    try:
        # ---- the replica --------------------------------------------------
        spec = ReplicaSpec(**RECIPE_SPEC)
        t0 = time.time()
        ids = write_replica(base, pred, aux, spec)
        write_s = time.time() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(root) for f in fs)
        sd = os.path.join(base, "ScanNet", "scan_data")
        voxels, segments, instances = [], [], []
        for scan in ids:
            pts = load_pth(os.path.join(sd, "pcd_with_global_alignment",
                                        f"{scan}.pth"))[0]
            voxels.append(len(quantize(np.asarray(pts, np.float32),
                                       0.02)[0]))
            segments.append(int(np.asarray(load_pth(os.path.join(
                sd, "segment_id", f"{scan}.pth"))).max()) + 1)
            instances.append(len(load_pth(os.path.join(
                sd, "instance_id_to_label", f"{scan}.pth"))))
        print(f"recipe: replica of {spec.n_train} + {spec.n_val} scans "
              f"written in {write_s:.1f} s, {nbytes / 2**20:.1f} MiB; "
              f"{spec.n_points} points a scan; voxels at 0.02 m {voxels}, "
              f"segments {segments}, instances {instances}", flush=True)
        out["replica"] = {"write_s": write_s, "bytes": nbytes,
                          "voxels": voxels, "segments": segments,
                          "instances": instances}

        # ---- stage 1, its resume, the GT-query variant --------------------
        s1, gtd, s2 = (os.path.join(root, d) for d in ("stage1", "gt",
                                                        "stage2"))
        common = [f"data.scene_verse_base={base}",
                  f"data.scene_verse_aux={aux}",
                  "data.load_scan_options.load_image_segment_feat=true",
                  "data.load_scan_options.load_point_segment_feat=true",
                  "model.voxel_encoder.args.pallas_conv=true",
                  "log_every=1", "device=cuda"]
        t1, r1 = recipe_stage("stage 1 (instseg_sceneverse)", [
            "--config-name", "instseg_sceneverse", *common, f"exp_dir={s1}",
            "solver.epochs=1", "solver.epochs_per_eval=1"], zrun_conv, True,
            card)
        m1 = last_metrics(s1, "val")
        del t1
        t1b, r1b = recipe_stage("stage 1 resumed", [
            "--config-name", "instseg_sceneverse", f"exp_dir={s1}",
            "resume=true", "solver.epochs=2", "solver.epochs_per_eval=2"],
            zrun_conv, True, card)
        m1b = last_metrics(s1, "val")
        lost = sorted(set(m1) - set(m1b))
        print(f"recipe: stage 1 eval (official protocol, full resolution) "
              f"{ {k: m1[k] for k in sorted(m1)[:4]} } ...; after the "
              f"resume (epoch {t1b.tracker.epoch}) "
              f"{ {k: m1b[k] for k in sorted(m1b)[:4]} } ...; "
              f"{len(m1b)} metrics", flush=True)
        if not (all_finite(m1) and all_finite(m1b)) or lost \
                or t1b.tracker.epoch != 2:
            fail(f"stage 1: metrics not finite or lost across the resume "
                 f"{lost}")

        # B1 on a batch of 4 of these scans (eval mode), beside the
        # synthetic phase's 4 served scenes
        cfg1 = t1b.cfg
        scenes_ds = SceneVerseInstSeg(cfg1, "train")
        batch = make_batch([scenes_ds.get_scene(i) for i in range(4)],
                           pipeline_config(cfg1["data"]["instseg_options"]),
                           np.random.default_rng(0))
        rows = level_rows(batch)
        routed = t1b.model.voxel_encoder.backbone.routed_convs(rows)
        print(f"recipe: 4 replica scans collated, flat level rows {rows}, "
              f"{len(routed)} routed convs a forward: "
              f"{[r[0] for r in routed]}", flush=True)
        fm = flatten_maps(to_device(batch["maps"], dev))
        b1 = b1_shapes(zrun_conv, fm, routed, dev, flops_peak, bw_peak,
                       "recipe")
        b1_ms = sum(r["ms"] * r["per_forward"] for r in b1)
        print(f"recipe: B1 {b1_ms:.3f} ms a forward (median per call, "
              f"summed over the {len(routed)} routed convs) on SceneVerse-"
              f"statistics scans against {synth_ms:.3f} ms on the synthetic "
              f"phase's scenes ({card})", flush=True)
        del t1b, fm, batch, scenes_ds
        torch.cuda.empty_cache()

        tgt, rgt = recipe_stage("GT-query variant (instseg_sceneverse_gt)", [
            "--config-name", "instseg_sceneverse_gt", *common,
            f"exp_dir={gtd}", "solver.epochs=1", "solver.epochs_per_eval=0"],
            zrun_conv, True, card)
        gt_loss = [e.get("loss", float("nan")) for e in rgt["epochs"]]
        if not rgt["offline_mask"] or not all(rgt["offline_mask"]) \
                or not all(math.isfinite(x) for x in gt_loss):
            fail(f"GT variant: offline masks {rgt['offline_mask']}, loss "
                 f"{gt_loss}")
        print(f"recipe: GT variant: every batch carries offline_attn_mask "
              f"{rgt['first']['offline_attn_mask'].shape}, direct loss "
              f"{gt_loss}", flush=True)
        tc = train_check_phase(tgt, zrun_conv, rgt["first"])
        del tgt
        torch.cuda.empty_cache()

        # ---- stage 2, warm-started from stage 1 ---------------------------
        t2, r2 = recipe_stage("stage 2 (unified_tasks_sceneverse)", [
            "--config-name", "unified_tasks_sceneverse",
            f"data.scene_verse_base={base}", f"data.scene_verse_aux={aux}",
            f"data.scene_verse_pred={pred}", "dataloader.batchsize=8",
            "dataloader.batchsize_eval=8", "solver.epochs=1",
            "solver.epochs_per_eval=1", "solver.sched.args.warmup_steps=10",
            f"pretrain_ckpt_path={os.path.join(s1, 'ckpt', 'latest')}",
            "log_every=1", "device=cuda", f"exp_dir={s2}"], zrun_conv,
            False, card)
        m2 = last_metrics(s2, "val-")
        sets = sorted({k.split("/")[0] for k in m2})
        print(f"recipe: stage 2 warm start loaded {len(t2.warm_started)} "
              f"tensors (predicted {RECIPE_WARM_START_LOADED}); eval of "
              f"{len(sets)} datasets, {len(m2)} metrics, target_metric "
              f"{ {k: m2[k] for k in m2 if k.endswith('target_metric')} }",
              flush=True)
        if len(t2.warm_started) != RECIPE_WARM_START_LOADED:
            fail("the warm start loaded another count than predicted")
        if not all_finite(m2) or len(sets) != 7:
            fail(f"stage 2: eval metrics not finite or missing: {sets}")
        del t2
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    runs = {"stage1": r1, "stage1_resume": r1b, "gt": rgt, "stage2": r2}
    for r in runs.values():
        r.pop("first", None)
    total = time.time() - t_phase
    print(f"recipe: phase {total:.1f} s ({card})", flush=True)
    out.update(runs=runs, b1=b1, b1_ms=b1_ms, train_check=tc,
               warm_started=RECIPE_WARM_START_LOADED, phase_s=total,
               launches={k: sum(runs[n]["counts"][k] for n in
                                ("stage1", "stage1_resume", "gt"))
                         for k in ("fwd", "bwd")})
    return out


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
    from pq3d_tpu_torch.ops import windowed_conv, zrun_conv
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

    # ---- 2. build: one nvcc for each source, all started together ------
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        builds = {name: pool.submit(mod.build) for name, mod in
                  (("zrun_conv.cu", zrun_conv),
                   ("windowed_conv.cu", windowed_conv))}
        for name, job in builds.items():
            try:
                job.result()
            except subprocess.CalledProcessError as e:
                fail(f"nvcc failed on {name}:\n{e.stderr[-4000:]}")
    print(f"build: {' and '.join(builds)} in {time.time() - t0:.1f} s",
          flush=True)
    for name, mod, kern, scale in (
            ("zrun_conv.cu", zrun_conv, "zrun_conv_kernel", 1),
            ("windowed_conv.cu", windowed_conv, "windowed_conv_kernel", 8)):
        regs = ptxas_summary(mod.build_log, kern, scale)
        print(f"build: {name} ptxas, Cout (of a block): registers / spills: "
              f"{'; '.join(regs)}", flush=True)
        if not regs:
            fail(f"no ptxas report in {name}'s build log")

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
    served = make_scenes(4, seed=1)
    batch = make_batch(served, pipe, np.random.default_rng(0))
    rows = level_rows(batch)
    most = [int(batch["maps"][f"valid_{l}"].sum(1).max()) for l in range(5)]
    print(f"pipeline: 4 scenes collated in {time.time() - t0:.1f} s, flat "
          f"level rows {rows}, most voxels in one scene per level {most} "
          f"(level caps {pipe.level_caps})", flush=True)
    fm = flatten_maps(to_device(batch["maps"], dev))
    routed = backbone.routed_convs(rows)
    print(f"routing: {len(routed)} convs per forward run zrun_conv: "
          f"{[r[0] for r in routed]}", flush=True)
    if not routed:
        fail("no conv of the slice routes to zrun_conv")
    per_shape = b1_shapes(zrun_conv, fm, routed, dev, flops_peak, bw_peak,
                          "kernel")
    shapes = {(r["level"], r["cin"], r["cout"]): r["per_forward"]
              for r in per_shape}
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
        windowed_conv.reset_counts()
        t0 = time.time()
        results = [f.result(timeout=900)
                   for f in [srv.submit(s) for s in scenes]]
        wall = time.time() - t0
        settle(srv, len(scenes))
        main_launches = zrun_conv.launches  # main path ends here
        b2_serve = windowed_conv.launches
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

    # ---- 6. winconv: kernel B2 on the served batch's coordinates --------
    wc = winconv_phase(served, batch, pipe, shapes,
                       {(r["level"], r["cin"], r["cout"]): r["ms"]
                        for r in per_shape}, dev, flops_peak, bw_peak)

    # ---- 7. kernel_bwd: the backward at a training batch's shapes -------
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

        # ---- 8. train ---------------------------------------------------
        windowed_conv.reset_counts()
        tr = train_phase(trainer, zrun_conv, warm, card)
        b2_train = windowed_conv.launches

        # ---- 9. train_check ---------------------------------------------
        tc = train_check_phase(trainer, zrun_conv, warm)
        if args.profile:
            stem, ext = os.path.splitext(args.profile)
            profile_run(lambda: trainer.train_batch(warm), "train step",
                        f"{stem}_train{ext}")
    finally:
        import shutil
        shutil.rmtree(exp_dir, ignore_errors=True)
    del trainer
    torch.cuda.empty_cache()

    # ---- 10. unified: stage-2 serving at full width ---------------------
    unified_phase(card, dev, args.profile)
    torch.cuda.empty_cache()

    # ---- 11. unified_train: stage-2 training at full width --------------
    unified_train_phase(card, dev, args.profile)
    torch.cuda.empty_cache()

    # ---- 12. recipe: the two-stage recipe on SceneVerse-layout files ----
    rc = recipe_phase(card, dev, zrun_conv,
                      sum(r["ms"] * r["per_forward"] for r in per_shape),
                      flops_peak, bw_peak)

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
        + tr["counts"]["bwd"] + rc["launches"]["fwd"]
        + rc["launches"]["bwd"],
        "launches_by_path": {"serve": main_launches,
                             "train_fwd": tr["counts"]["fwd"],
                             "train_bwd": tr["counts"]["bwd"],
                             "recipe_fwd": rc["launches"]["fwd"],
                             "recipe_bwd": rc["launches"]["bwd"]},
        "max_abs_err": max(r["max_abs_err_f32"] for r in per_shape),
        "ms": per_fwd("ms"), "host_ms": per_fwd("host_ms"),
        "plain_ms": per_fwd("plain_ms"), "bound_ms": per_fwd("bound_ms"),
        "bound_by": max(per_shape, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": None,
        "scope": f"ms/host_ms/plain_ms/bound_ms: sum over the "
                 f"{len(routed)} routed convs of one served forward (B=4), "
                 f"ms the median device-clock time of a call, host_ms the "
                 f"wrapper's host time per call; bwd_*: sum of the dx "
                 f"launches over the {len(troutes)} routed convs of one "
                 f"train step (B=4); launches: the serving run, the "
                 f"5 timed train steps and the recipe's stage-1 runs "
                 f"(train and eval forwards, dx); recipe_ms: the same sum "
                 f"as ms over one forward of 4 SceneVerse-replica scans",
        "recipe_ms": rc["b1_ms"], "recipe_shapes": rc["b1"],
        "recipe_train_check": rc["train_check"],
        "shapes": per_shape,
        "bwd_launches": tr["counts"]["bwd"],
        "bwd_ms": per_step("ms"), "bwd_host_ms": per_step("host_ms"),
        "bwd_plain_ms": per_step("plain_ms"),
        "bwd_bound_ms": per_step("bound_ms"),
        "bwd_bound_by": max(bwd, key=lambda r: r["bound_ms"])["bound_by"],
        "bwd_max_abs_err": max(r["max_abs_err_dx"] for r in bwd),
        "dw_regather_ms": per_step("dw_ms"),
        "dw_regather_bound_ms": per_step("dw_bound_ms"),
        "bwd_shapes": bwd,
        "train_check": tc,
        # shares of one forward's (dx: one step's) N x 27 slots and (tile,
        # tap) pairs, weighted by each conv's dense N x 27 x Cin x Cout work
        "slot_share": per_fwd("flops") / per_fwd("dense27_flops"),
        "mult_share": per_fwd("mult_flops") / per_fwd("dense27_flops"),
        "bwd_mult_share": per_step("mult_flops") / sum(
            2.0 * r["n"] * 27 * r["cin"] * r["cout"] * r["per_step"]
            for r in bwd),
    }
    routed_b2 = [r for r in wc["shapes"] if r["per_forward"]]

    def b2_fwd(key):
        return sum(r[key] * r["per_forward"] for r in routed_b2)
    b2_entry = {
        "name": "windowed_conv", "route": "cuda",
        "source": "pq3d_tpu_torch/csrc/windowed_conv.cu",
        "replaces": "pq3d_tpu/ops/pallas_conv.py:205",
        "launches": wc["launches"],
        "launches_by_path": {"serve": b2_serve, "train": b2_train,
                             "winconv": wc["launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in wc["shapes"]),
        "ms": b2_fwd("ms"), "plain_ms": b2_fwd("plain_ms"),
        "bound_ms": b2_fwd("bound_ms"),
        "bound_by": max(routed_b2, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": None,
        "kernel_ms": b2_fwd("kernel_ms"),
        "b1_ms": b2_fwd("b1_ms"),
        # the share of one forward's dense N x K x Cin x Cout work in the
        # (16-row, tap) pairs the kernel multiplies
        "mult_share": b2_fwd("mult_flops") / b2_fwd("dense_flops"),
        "fold_s": sum(r["fold_s"] for r in wc["levels"] if r["k"] == 27),
        "scope": f"ms/kernel_ms/plain_ms/bound_ms/b1_ms: sum over the "
                 f"{len(routed)} routed convs of one served forward (B=4) on "
                 f"Morton-ordered maps of the same coordinates; ms is the "
                 f"wrapper (bf16 cast, W's layout, kernel), kernel_ms the "
                 f"launch alone; fold_s: host seconds of fold_exceptions "
                 f"over the levels' 3^3 maps; launches: the winconv phase "
                 f"(B2 is on no model path)",
        "levels": wc["levels"], "shapes": wc["shapes"],
    }
    print(f"summary: B1 {entry['ms']:.3f} ms per served forward (host "
          f"{entry['host_ms']:.3f} ms) against B2 {b2_entry['ms']:.3f} ms "
          f"(kernel alone {b2_entry['kernel_ms']:.3f} ms, multiplied share "
          f"{b2_entry['mult_share']:.4f}) in this run, ratio "
          f"{entry['ms'] / b2_entry['ms']:.3f}; B1 dx "
          f"{entry['bwd_ms']:.3f} ms per train step (host "
          f"{entry['bwd_host_ms']:.3f} ms); multiplied share of the dense work {entry['mult_share']:.4f} "
          f"forward, {entry['bwd_mult_share']:.4f} dx", flush=True)
    print(json.dumps({"kernels": [entry, b2_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
