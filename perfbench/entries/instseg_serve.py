"""Stage-1 serving: ``InstSegServer.submit`` under a closed loop of
clients, judged against the plain reference.

Set-up makes the traffic's scenes from the run's seed, builds the model
from the configuration in the cell's ``layout``
(``config.serving_config``), loads its weights (``weights.make_state``
from the run's seed, the segment projections centred on the first
``centre_scenes`` scenes by ``weights.centre_projections``), starts the
server and warms it with ``warm_rounds`` requests a client.  The window
then runs the clients for ``--seconds``: each client sends its next scene
as soon as its last answer came.  Requests are submitted one at a time
under a lock, so their sequence number is the order the server's queue
holds them in.

A forward hook on the model keeps, for every forward, a fingerprint of
each batch row's voxel segment ids (which scene the row holds), and every
round's class and mask logits of ``sample_count`` forwards drawn from the
seed out of all the window's forwards (a reservoir, since their number is
not known before the window closes).  After the window the rows are
matched to the requests (the server batches its queue in order and pads
a short batch by repeating its last row), and each sampled request is
judged:

- ``logit_gap``: the widest gap between the program's and the reference's
  logits of any round, over the reference's largest magnitude in that
  round (mask logits over the scene's segments, class logits over the
  classes kept); the reference's decoder attends where the program's mask
  logits of the round before let it;
- ``rank_mismatch``: the instances served for the request that the
  reference's ranking of the program's final logits does not give, and
  the reverse.

Beside them the run prints the share of false attend bits over the real
segments in the judged rounds after the first (round 0's queries are 0,
so its mask logits are 0 and it attends everywhere).
"""
from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List

import numpy as np

ROUND_KEYS = ("predictions_class", "predictions_mask")


class Recorder:
    """Forward hook: row fingerprints and start times of every forward,
    all rounds of a reservoir sample of the window's forwards, and the
    traced windows.  A row's fingerprint is the sum of its voxels'
    segment ids and their sum weighted by the voxel's place (1, 2, ...),
    summed on the device."""

    def __init__(self):
        self.count = 0
        self.rows = 0
        self.prints: List = []
        self.starts: List[float] = []
        self.kept: Dict[int, tuple] = {}
        self.rng = None
        self.sample_count = 0
        self.first = 0
        # the profilers run on the server's thread (one records the host
        # operators of the thread that starts it): each asked-for window
        # starts before the first forward after it is asked for, and
        # stops after the first forward that ends once its stop is asked
        self.lock = threading.Lock()
        self.asked: List[bool] = []
        self.stops = 0
        self.active = None
        self.started = threading.Event()
        self.windows: List[Dict] = []

    def sample(self, rng, count: int) -> None:
        """Keep the rounds of ``count`` forwards, drawn by ``rng`` from
        those from the next one on."""
        self.rng, self.sample_count, self.first = rng, count, self.count

    def ask(self, host: bool, seconds: float, limit: float) -> None:
        """A traced window, from the next forward on, and its stop asked
        for ``seconds`` after it started (a profiler of the host's
        operators takes seconds to start), waiting at most until
        ``limit`` (perf_counter seconds) for the start."""
        self.started.clear()
        with self.lock:
            self.asked.append(host)
        if not self.started.wait(max(limit - time.perf_counter(), 0.0)):
            with self.lock:
                if self.asked:
                    self.asked.pop()
            return
        sleep_until(time.perf_counter() + seconds)
        self.ask_stop()

    def ask_stop(self) -> None:
        with self.lock:
            self.stops += 1

    def pre(self, module, args):
        self.starts.append(time.perf_counter())
        with self.lock:
            host = self.asked.pop(0) \
                if self.active is None and self.asked else None
        if host is not None:
            from perfbench.trace import start_profiler
            prof = start_profiler(host)
            self.active = {"host": host, "prof": prof, "k0": self.count,
                           "t0": time.perf_counter()}
            self.started.set()

    def stop_trace(self) -> None:
        if self.active is not None:
            t1 = time.perf_counter()
            self.active["prof"].stop()
            self.active.update(t1=t1, k1=self.count)
            self.windows.append(self.active)
            self.active = None

    def __call__(self, module, args, out):
        import torch
        v = args[0]["voxel2segment"].long()
        self.rows = v.shape[1]
        place = torch.arange(1, v.shape[1] + 1, device=v.device)
        self.prints.append(torch.stack([v.sum(1), (v * place).sum(1)], 1))
        if self.rng is not None:
            n = self.count - self.first
            slot = n if n < self.sample_count \
                else int(self.rng.integers(0, n + 1))
            if slot < self.sample_count:
                old = [k for k in self.kept if k >= self.first]
                if len(old) == self.sample_count:
                    del self.kept[sorted(old)[slot]]
                self.kept[self.count] = tuple(list(out[k])
                                              for k in ROUND_KEYS)
        self.count += 1
        with self.lock:
            stop = self.stops > 0 and self.active is not None
            if stop:
                self.stops -= 1
        if stop:
            self.stop_trace()


class ClosedLoop:
    """Clients that each keep one request in flight, with no thread of
    their own: a client's next request is submitted from the done-callback
    of its last one, in the thread that resolved it, the moment the answer
    is there (a closed loop with no think time).  ``log`` holds, by
    sequence number (the order of the server's queue), [client, scene,
    submit time, answer time or None, answered]; ``results`` the answers
    of the sequence numbers in ``keep``; ``errors`` what failed requests
    raised."""

    def __init__(self, srv, scenes, orders):
        self.srv, self.scenes, self.orders = srv, scenes, orders
        self.lock = threading.RLock()
        self.idle = threading.Condition(self.lock)
        self.log: List[list] = []
        self.results: Dict[int, object] = {}
        self.errors: List[str] = []
        self.keep = range(0, 0)
        self.cursor = [0] * len(orders)
        self.budget = [0] * len(orders)
        self.deadline = 0.0
        self.pending = 0

    def start(self, budget: int, deadline: float) -> None:
        """Each client sends up to ``budget`` requests, none submitted
        after ``deadline`` (perf_counter seconds)."""
        with self.lock:
            self.budget = [budget] * len(self.orders)
            self.deadline = deadline
            for c in range(len(self.orders)):
                self._send(c)

    def wait(self, limit_s: float) -> None:
        """Until no request is in flight, or ``limit_s`` seconds."""
        end = time.perf_counter() + max(limit_s, 0.0)
        with self.lock:
            while self.pending and time.perf_counter() < end:
                self.idle.wait(min(0.5, max(end - time.perf_counter(), 0)))

    def _send(self, c: int) -> None:
        if self.budget[c] <= 0 or time.perf_counter() >= self.deadline:
            return
        self.budget[c] -= 1
        sc = self.orders[c][self.cursor[c]]
        self.cursor[c] += 1
        seq = len(self.log)
        self.log.append([c, sc, time.perf_counter(), None, False])
        self.pending += 1
        fut = self.srv.submit(self.scenes[sc])
        fut.add_done_callback(lambda f: self._done(f, c, seq))

    def _done(self, fut, c: int, seq: int) -> None:
        t = time.perf_counter()
        with self.lock:
            try:
                res = fut.result()
                ok = isinstance(res, list)
            except Exception as e:     # a failed request is counted
                res, ok = None, False
                self.errors.append(repr(e)[:500])
            self.log[seq][3], self.log[seq][4] = t, ok
            if seq in self.keep:
                self.results[seq] = res
            self.pending -= 1
            try:
                self._send(c)
            finally:
                if not self.pending:
                    self.idle.notify_all()


def build(cell: Dict, config: Dict, device: str, control: str, seed: int,
          scenes: List[Dict]):
    """(model, pipeline config, weight shapes, the centred projection
    biases)."""
    import torch
    from pq3d_tpu_torch.config import serving_config
    from pq3d_tpu_torch.data.instseg_pipeline import pipeline_config
    from pq3d_tpu_torch.models.query3d import build_model
    from perfbench.weights import centre_projections, make_state

    port = config["port"]
    cfg = serving_config(cell["entry_args"]["layout"],
                         list(port.get("overrides", ())))
    check_arch(cfg, config["arch"])
    pipe = pipeline_config(cfg["data"]["instseg_options"])
    if pipe.fps_subsample != config["arch"]["fps_subsample"]:
        raise ValueError(f"the pipeline subsamples FPS at "
                         f"{pipe.fps_subsample}, the configuration states "
                         f"{config['arch']['fps_subsample']}")
    model = build_model(cfg, device=device, seed=0)
    shapes = {k: (tuple(v.shape), v.dtype)
              for k, v in model.state_dict().items()}
    state = make_state(shapes, seed, device)
    missing = set(shapes) - set(state)
    if any(shapes[k][1].is_floating_point for k in missing):
        raise ValueError(f"weights not made for {sorted(missing)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    biases = centre_projections(state, scenes[:config["centre_scenes"]],
                                config["arch"], device)
    state.update(biases)
    model.load_state_dict(state, strict=False)
    del state
    if control == "bf16":
        from pq3d_tpu_torch.utils.inference import cast_model_bf16
        cast_model_bf16(model)
    torch.cuda.empty_cache() if device == "cuda" else None
    return model, pipe, shapes, biases


def check_arch(cfg: Dict, arch: Dict) -> None:
    """The configuration file's sizes against the resolved config."""
    m, io = cfg["model"], cfg["data"]["instseg_options"]
    ue = m["unified_encoder"]["args"]
    got = {"hidden_size": m["hidden_size"],
           "num_heads": ue["num_attention_heads"],
           "num_layers": ue["num_layers"], "num_blocks": ue["num_blocks"],
           "memories": list(m["memories"]),
           "num_queries": io["num_queries"],
           "max_segments": io["max_segments"],
           "voxel_size": io["voxel_size"],
           "level_caps": list(io["level_caps"]),
           "num_targets": m["mask_head"]["args"]["num_targets"],
           "filter_out_classes": list(io["filter_out_classes"]),
           "hlevels": list(m["voxel_encoder"]["args"]["hlevels"])}
    diff = {k: (v, arch.get(k)) for k, v in got.items() if arch.get(k) != v}
    if diff:
        raise ValueError(f"configuration file and resolved config differ "
                         f"(resolved, file): {diff}")


def run(ctx: Dict) -> Dict:
    import torch
    from pq3d_tpu_torch.serve import InstSegServer
    from perfbench.generators import instseg_scenes

    cell, config, traffic = ctx["cell"], ctx["config"], ctx["traffic"]
    seed, seconds, device = ctx["seed"], ctx["seconds"], ctx["device"]
    arch = config["arch"]
    ea = cell["entry_args"]
    scenes = instseg_scenes.make_scenes(seed, traffic)
    model, pipe, shapes, biases = build(cell, config, device,
                                        ctx.get("control", ""), seed, scenes)
    clients = traffic["clients"]
    orders = instseg_scenes.client_orders(seed, len(scenes), clients, 100000)
    cast = None
    if ctx.get("control") == "bf16":
        from pq3d_tpu_torch.utils.inference import cast_batch_bf16
        cast = cast_batch_bf16
    rec = Recorder()
    hooks = [model.register_forward_pre_hook(rec.pre),
             model.register_forward_hook(rec)]
    srv = InstSegServer(
        model, pipe, batch_size=ea["batch_size"],
        num_classes=arch["num_targets"] - 1, topk=ea["topk"],
        max_delay_s=ea["max_delay_s"],
        extra_features={m: arch["mv_dim"] for m in arch["memories"]
                        if m != "voxel"},
        device=device, num_workers=ea["num_workers"], cast=cast)

    loop = ClosedLoop(srv, scenes, orders)
    try:
        loop.start(traffic["warm_rounds"], float("inf"))
        loop.wait(1200.0)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        srv.stats = type(srv.stats)()
        k0 = rec.count
        rec.sample(np.random.default_rng([seed, 2]), traffic["sample_count"])
        s0 = len(loop.log)
        loop.keep = range(s0, 2 ** 62)
        gc.collect()
        gc.freeze()
        t0 = time.perf_counter()
        setup_s = time.time() - ctx["t_start"]
        t_end = t0 + seconds
        loop.start(10 ** 9, t_end)
        if ctx["trace"]:
            # the device alone first, then the host's operators as well
            for host, key in ((False, "trace_device"), (True, "trace_host")):
                a, b = traffic[key]
                sleep_until(t0 + a * seconds)
                rec.ask(host, (b - a) * seconds, t_end)
        # an answer may come up to a minute past the window's close
        loop.wait(t_end + 60.0 - time.perf_counter())
        gc.unfreeze()
        rec.stop_trace()
        stages = dict(srv.stats.stage_s)
        steps = srv.stats.steps
        if device == "cuda":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        else:
            peak = 0
    finally:
        srv.close()
        for h in hooks:
            h.remove()

    # ---- after the window: the readings, then the program's state freed
    log, results, errors = loop.log, loop.results, loop.errors
    done = [row for row in log[s0:] if row[3] is not None and row[4]
            and row[3] <= t_end]
    attempted = len(log) - s0
    failed = sum(1 for row in log[s0:] if not row[4])
    lat = np.array([row[3] - row[2] for row in done])
    prints = torch.stack(rec.prints).cpu().numpy()
    rows, rec_count, starts = rec.rows, rec.count, rec.starts
    kept = {k: tuple([t.float().cpu() for t in ts] for ts in v)
            for k, v in rec.kept.items()}
    windows = rec.windows
    del srv, model, rec
    if device == "cuda":
        torch.cuda.empty_cache()

    seq_of, notes = map_rows(scenes, log, prints, rows, ea["batch_size"],
                             arch)
    judged = judge(ctx, config, shapes, biases, scenes, log, seq_of, kept,
                   results, ea["batch_size"])
    judged["notes"] = notes + judged["notes"]
    judged["notes"] += [f"{len(errors)} requests failed, the first with "
                        f"{errors[0]}"] if errors else []
    n_fwd = rec_count - k0
    kept_answers = [r for r in results.values() if isinstance(r, list)]
    sizes = [len(r) for r in kept_answers]
    diag = (f"window: {n_fwd} forwards, {len(done)} answered, "
            f"{len(done) / max(n_fwd, 1):.2f} answers a forward, "
            f"{np.mean(sizes) if sizes else 0:.1f} instances an answer; "
            f"server "
            f"seconds a batch: " + ", ".join(
                f"{k} {v / max(steps, 1):.4f}" for k, v in sorted(
                    stages.items())))
    out = {"attempted": attempted, "failed": failed, "setup_s": setup_s,
           "diag": diag,
           "peak_bytes": peak, "compared": judged["compared"],
           "notes": judged["notes"], "worst": judged["worst"],
           "e2e": {"serve_requests_per_s": len(done) / seconds,
                   # no answer at all reads as the longest wait allowed
                   "serve_p95_s": (float(np.percentile(lat, 95))
                                   if len(lat) else seconds + 60.0),
                   "peak_mem_gib": peak / 2 ** 30,
                   "setup_s": setup_s}}
    if judged["false_share"] is not None:
        out["diag"] += (f"; false attend bits {judged['false_share']:.4f} "
                        f"of the judged rounds after the first")
    if ctx["trace"]:
        if [w["host"] for w in windows] != [False, True]:
            raise RuntimeError(f"the traced windows did not both run "
                               f"({errors[:1]})")
        out["layer_ctx"] = layer_context(
            ctx, config, shapes, scenes, windows, starts, stages, steps,
            [row[1] for row in done], seq_of, log)
    return out


def sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def fingerprint(v2s: np.ndarray, segments: int, rows: int) -> tuple:
    """``Recorder``'s fingerprint of a scene's voxel segment ids, clipped
    to the trash id ``segments`` and padded with it to ``rows``."""
    v = np.full(rows, segments, np.int64)
    v[:len(v2s)] = np.minimum(v2s, segments)
    return int(v.sum()), int((v * np.arange(1, rows + 1)).sum())


def map_rows(scenes, log, prints, rows, batch, arch):
    """({(forward, row): sequence number}, notes): the rows of every
    forward matched to the requests, in the queue's order, a short batch
    padded by its last row."""
    from perfbench.reference import instseg as ref

    S = arch["max_segments"]
    finger = {}
    for i, s in enumerate(scenes):
        v2s = ref.voxel_inputs(s, arch["voxel_size"])[2]
        finger.setdefault(fingerprint(v2s, S, rows), []).append(i)
    notes: List[str] = []
    seq_of: Dict[tuple, int] = {}
    c = 0
    for k, fwd in enumerate(prints):
        ids = [finger.get(tuple(r.tolist()), [-1]) for r in fwd]
        r = 1
        while r < batch and ids[r] != ids[r - 1]:
            r += 1
        for i in range(r):
            j = c + i
            if j >= len(log) or log[j][1] not in ids[i]:
                notes.append(f"forward {k} row {i} does not hold request "
                             f"{j}'s scene")
                break
            seq_of[(k, i)] = j
        c += r
    if c != len(log):
        notes.append(f"the forwards held {c} requests, {len(log)} were sent")
    return seq_of, notes


def judge(ctx, config, shapes, biases, scenes, log, seq_of, kept, results,
          batch):
    """The compared numbers (see the module docstring), and the share of
    false attend bits."""
    import torch
    from perfbench.reference import instseg as ref
    from perfbench.weights import make_state

    arch, device = config["arch"], ctx["device"]
    S = arch["max_segments"]
    notes: List[str] = []
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = make_state(shapes, ctx["seed"], device)
    sd.update(biases)
    n_vox = [ref.n_voxels(s, arch["voxel_size"]) for s in scenes]
    cands = ref.query_candidates([n_vox[row[1]] for row in log],
                                 arch["fps_subsample"], arch["num_queries"])
    need = sorted((seq_of[(k, i)], k, i) for k in kept
                  for i in range(batch) if (k, i) in seq_of)
    gap, mismatch, judged, worst = 0.0, 0, 0, ""
    false_bits, bits = 0, 0
    cand_at, j_next = {}, 0
    for j, _, _ in need:
        while j_next <= j:
            cand_at[j_next] = next(cands)
            j_next += 1
    filtered = arch["filter_out_classes"]
    kept_cols = [t for t in range(arch["num_targets"]) if t not in filtered]
    with torch.no_grad():
        for j, k, i in need:
            scene = scenes[log[j][1]]
            prep = ref.prepare_scene(scene, arch["voxel_size"],
                                     arch["num_queries"], S, cand_at[j])
            cls_p = [t[i] for t in kept[k][0]]
            mask_p = [t[i] for t in kept[k][1]]
            out = ref.forward_scene(sd, prep, arch,
                                    [m.to(device) for m in mask_p[:-1]],
                                    device)
            valid = out["seg_valid"].cpu()
            for m in mask_p[1:-1]:
                att = ref.attend_from(m)[:, valid]
                false_bits += int((~att).sum())
                bits += att.numel()
            for r in range(len(out["mask"])):
                pairs = (("mask", mask_p[r][valid],
                          out["mask"][r].cpu()[valid]),
                         ("class", cls_p[r][:, kept_cols],
                          out["cls"][r].cpu()[:, kept_cols]))
                for kind, got, want in pairs:
                    g = ((got - want).abs().max()
                         / want.abs().max().clamp_min(1e-12)).item()
                    if g > gap:
                        gap, worst = g, f"{kind} round {r} request {j}"
            judged += 1
            served = results.get(j)
            if served is not None:
                mine = ref.rank(cls_p[-1].numpy(), mask_p[-1].numpy(),
                                valid.numpy(), prep["seg_to_full"],
                                arch["num_targets"] - 1,
                                ctx["cell"]["entry_args"]["topk"])
                mismatch += rank_mismatch(served, mine)
    if not judged:
        notes.append("no sampled request was judged")
    return {"compared": {"logit_gap": gap, "rank_mismatch": mismatch},
            "notes": notes, "worst": worst,
            "false_share": false_bits / bits if bits else None}


def rank_mismatch(served, mine) -> int:
    """Instances in one list and not the other: same class, score within
    a millionth, same mask."""
    left = dict(mine)
    miss = 0
    for p in served:
        hit = None
        for key, (score, mask) in left.items():
            if key[1] == p["class"] and abs(score - p["score"]) \
                    <= 1e-6 * max(abs(score), 1e-30) \
                    and np.array_equal(mask, p["mask"]):
                hit = key
                break
        if hit is None:
            miss += 1
        else:
            del left[hit]
    return miss + len(left)


def layer_context(ctx, config, shapes, scenes, windows, starts, stages,
                  steps, done_scenes, seq_of, log) -> Dict:
    """What the per-layer readers read: the two traced windows, the
    forwards in the second with the real voxels and 3^3 references of
    their scenes, the server's stage seconds, and the operations of the
    window's answered requests."""
    import torch
    from perfbench import trace as tr_mod
    from perfbench.count import instseg as count
    from perfbench.reference import instseg as ref

    arch, device = config["arch"], ctx["device"]
    stats = []
    with torch.no_grad():
        for s in scenes:
            coords = ref.voxelize(s["points"].astype(np.float32),
                                  arch["voxel_size"])[0]
            lv, _, _ = ref.hierarchy(torch.as_tensor(coords, device=device))
            n = [len(level.coords) for level in lv]
            pairs3 = [int((level.neighbours(3) >= 0).sum()) for level in lv]
            k0 = round(shapes["voxel_encoder.backbone.conv0.kernel"][0][0]
                       ** (1 / 3))
            stem = int((lv[0].neighbours(k0) >= 0).sum())
            segs = min(int(s["segment_id"].max()) + 1, arch["max_segments"])
            stats.append({"n": n, "pairs3": pairs3, "pairs_stem": stem,
                          "segments": segs})
    shp = {k: v[0] for k, v in shapes.items()}
    flops = sum(count.scene_flops(shp, stats[i], arch) for i in done_scenes)
    dev_w, host_w = windows
    # each forward of the second window: its start on that window's clock
    # and the real rows and references, by level, of the scenes it held
    forwards = []
    for k in range(host_w["k0"], host_w["k1"]):
        held = [stats[log[j][1]] for (f, _), j in seq_of.items() if f == k]
        forwards.append({
            "start": starts[k] - host_w["t0"],
            "n": [sum(h["n"][l] for h in held) for l in range(5)],
            "pairs3": [sum(h["pairs3"][l] for h in held)
                       for l in range(5)]})
    return {"trace": tr_mod.reduce(dev_w["prof"],
                                   dev_w["t1"] - dev_w["t0"]),
            "traced_forwards": dev_w["k1"] - dev_w["k0"],
            "trace_host": tr_mod.reduce(host_w["prof"],
                                        host_w["t1"] - host_w["t0"]),
            "host_forwards": forwards,
            "stages": stages, "steps": steps, "flops": flops,
            "seconds": ctx["seconds"], "device_name": ctx["device_name"],
            "level_caps": arch["level_caps"],
            "batch": ctx["cell"]["entry_args"]["batch_size"]}
