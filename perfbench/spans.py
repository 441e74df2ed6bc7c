"""The program's spans and counters (the recorder of
``pq3d_tpu_torch.utils.profiling``) put on the clock of the traced window
that records the device alone.

The recorder keeps what the server and the forward recorded while a
profiler ran, grouped by session; the stage-1 serving entry runs its
device-only window first, so session 1 is that window's.  The window
holds no host event and its start is not kept, so the spans are put on
its clock by the synchronising copies: each ``server.readback`` ends
right after its last pageable ``Memcpy DtoH`` has ended, and those copies
are device intervals of the window.  The offset is first the one that
matches the most readbacks to a copy ending at most ``MATCH_S`` before
each (of those that match as many, the smallest); then, where at least
``FIT_MIN`` readbacks match, a rate as well: a least-squares line of the
matched readbacks' (end - copy end) against their ends, put under the
smallest so that every gap is at least 0, refitted once over what it
matches, and kept where it matches no fewer.  The residual is the
spread of (readback end - copy end) over the matched readbacks, on the
fitted clock.  A program without the recorder, or a window with no
copy that matches, gives nothing: every reader of this module then
returns None.

A traced run also prints, to standard error, the host window's largest
idle gaps with their times (``host_gaps``) and the server's untraced
dispatch a batch beside the traced one.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

MATCH_S = 1e-3
FIT_MIN = 4
READBACK = "server.readback"
COPY = "Memcpy DtoH"
# the server thread's stages; a forward's spans run inside its dispatch
DISPATCH = ("server.dispatch", "model.maps", "model.backbone",
            "model.decoder")
HOST_WORK = ("server.preprocess", "server.collate", "server.readback",
             "server.rank")


def recorded_sessions() -> Optional[Dict[int, list]]:
    """The recorder's spans by session, or None where the program has no
    recorder."""
    try:
        from pq3d_tpu_torch.utils import profiling
    except ImportError:
        return None
    get = getattr(profiling, "sessions", None)
    return get() if callable(get) else None


def align(readback_ends: List[float], copy_ends: List[float],
          match_s: float = MATCH_S
          ) -> Optional[Tuple[float, float, List[float]]]:
    """(offset, rate, the matched readbacks' gaps), seconds: a readback's
    time ``t`` is ``t - offset - rate * t`` on the copies' clock, and its
    gap is its end there less the end of the latest copy that ended at
    most ``match_s`` before it.  None when nothing matches."""
    import numpy as np
    r = np.asarray(readback_ends, float)
    c = np.asarray(copy_ends, float)
    if not len(r) or not len(c):
        return None

    def match(off, rate):
        lag = (r - off - rate * r)[:, None] - c[None, :]
        ok = (lag >= -1e-9) & (lag <= match_s + 1e-9)
        gap = np.where(ok, lag, np.inf).min(1)
        return ok.any(1), gap

    best = None
    for off in np.unique((r[:, None] - c[None, :]).ravel()):
        n = int(match(off, 0.0)[0].sum())
        if best is None or n > best[0]:
            best = (n, float(off), 0.0)
    for _ in range(2):
        n, off, rate = best
        hit, gap = match(off, rate)
        if n < FIT_MIN or np.ptp(r[hit]) <= 0:
            break
        # the matched pairs' raw (readback end - copy end), fitted
        t = r[hit]
        d = gap[hit] + off + rate * t
        slope, icept = np.polyfit(t, d, 1)
        icept += float((d - icept - slope * t).min())
        m = int(match(icept, slope)[0].sum())
        if m < n:
            break
        best = (m, float(icept), float(slope))
    n, off, rate = best
    hit, gap = match(off, rate)
    return off, rate, [max(float(g), 0.0) for g in gap[hit]]


def window_spans(ctx: Dict) -> Optional[Dict]:
    """Session 1's spans on the device-only window's clock (kept in
    ``ctx``): ``spans`` (dicts of name, start, end in window seconds, ids,
    value, device_ms, parent), ``matched`` and ``readbacks``,
    ``offset_ns`` (the window's start on the recorder's clock), ``rate``
    and ``residual_ms``.  None without the recorder, its first session, or
    a match."""
    if "_window_spans" in ctx:
        return ctx["_window_spans"]
    ctx["_window_spans"] = None
    tr = ctx.get("trace")
    if tr is None:
        return None
    sessions = recorded_sessions()
    host_gaps(ctx, sessions)
    if not sessions:
        return None
    first = sessions[min(sessions)]
    base = min(s.start_ns for s in first)
    reads = [(s.end_ns - base) * 1e-9 for s in first
             if s.name == READBACK and s.end_ns is not None]
    copies = [e for n, _, e in tr.device if n.startswith(COPY)]
    found = align(reads, copies)
    if found is None:
        return None
    off, rate, gaps = found

    def clock(ns):
        t = (ns - base) * 1e-9
        return t - off - rate * t
    spans = []
    for s in first:
        end = s.end_ns if s.end_ns is not None else s.start_ns
        spans.append({"name": s.name, "start": clock(s.start_ns),
                      "end": clock(end), "ids": dict(s.ids),
                      "value": s.value, "device_ms": s.device_ms,
                      "parent": s.parent})
    out = {"spans": spans, "matched": len(gaps), "readbacks": len(reads),
           "offset_ns": base + round(off / (1 - rate) * 1e9),
           "rate": rate, "residual_ms": (max(gaps) - min(gaps)) * 1e3}
    names = {s.name for s in first}
    on_device = sum(d[0] in names for t in (tr, ctx.get("trace_host"))
                    if t is not None for d in t.device)
    # the dispatch whose forward stops the profiler ends after the stop's
    # seconds of work: only those that end inside the window are a launch
    disp = [s["end"] - s["start"] for s in spans
            if s["name"] == "server.dispatch" and s["end"] <= tr.end]
    fwd = ctx.get("traced_forwards")
    kern = sum(e - a for _, a, e in tr.kernels()) / fwd if fwd else 0.0
    print(f"perfbench: spans on the device window's clock: "
          f"{out['matched']} of {out['readbacks']} readbacks matched to a "
          f"DtoH copy ending at most {MATCH_S * 1e3:g} ms before, residual "
          f"{out['residual_ms']:.4f} ms (spread of readback end - copy "
          f"end), rate {rate * 1e6:.2f} ppm, window start "
          f"{out['offset_ns']} ns; mean server.dispatch "
          f"{1e3 * sum(disp) / max(len(disp), 1):.3f} ms, kernel ms a "
          f"traced forward {1e3 * kern:.3f}; device intervals named as a "
          f"span {on_device}", file=sys.stderr)
    # the untraced dispatch: the server's always-on sum less the dispatch
    # spans of both traced windows (a dispatch that starts a profiler
    # stays in it, with the start's few ms)
    every = [s for ss in sessions.values() for s in ss
             if s.name == "server.dispatch" and s.end_ns is not None]
    stages, steps = ctx.get("stages") or {}, ctx.get("steps") or 0
    if "put_dispatch" in stages and steps > len(every) and disp:
        untraced = (stages["put_dispatch"] - sum(
            (s.end_ns - s.start_ns) * 1e-9 for s in every)) \
            / (steps - len(every))
        traced = sum(disp) / len(disp)
        print(f"perfbench: server.dispatch a batch: untraced (stage_s "
              f"outside the traced windows, {steps - len(every)} batches) "
              f"{untraced * 1e3:.3f} ms, in the device-only window "
              f"{traced * 1e3:.3f} ms, traced / untraced "
              f"{traced / untraced:.4f}", file=sys.stderr)
    ctx["_window_spans"] = out
    return out


def host_gaps(ctx: Dict, sessions: Optional[Dict[int, list]],
              n: int = 6) -> None:
    """Print the host window's ``n`` largest idle gaps with their start
    and end in window seconds, the label ``perfbench/trace.py`` gives
    them (the innermost host operator at the middle), the host operators
    at the start, middle and end, and the program's spans of the
    window's session (its second) around the middle, put on the window's
    clock by the host spans' ``record_function`` events."""
    th = ctx.get("trace_host")
    if th is None:
        return
    ivs = sorted((a, b) for _, a, b in th.device)
    gaps, end = [], th.start
    for a, b in ivs:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if th.end > end:
        gaps.append((end, th.end))
    gaps.sort(key=lambda g: g[0] - g[1])
    placed = _host_window_spans(th, sessions)

    def ops_at(t):
        inner = sorted((h for h in th.host if h[1] <= t <= h[2]),
                       key=lambda h: -h[1])
        return [f"{h[0][:60]} {h[1]:.4f}-{h[2]:.4f}" for h in inner[:3]]
    for k, (a, b) in enumerate(gaps[:n]):
        mid = (a + b) / 2
        label = (ops_at(mid) or ["no operator (Python on the host)"])[0]
        around = [f"{nm} {s0:.4f}-{s1:.4f} (batch {batch})"
                  for nm, s0, s1, batch in placed if s0 <= mid <= s1]
        print(f"perfbench: host window gap {k + 1}: {a:.4f}-{b:.4f} s "
              f"({b - a:.4f} s), label {label}; operators at its start ["
              f"{'; '.join(ops_at(a))}], middle [{'; '.join(ops_at(mid))}]"
              f", end [{'; '.join(ops_at(b))}]; spans at its middle ["
              f"{'; '.join(around) if placed else 'none kept'}]",
              file=sys.stderr)


def _host_window_spans(th, sessions) -> list:
    """(name, start, end, batch) of the second session's spans on the host
    window's clock: the offset that puts the most host spans within 1 ms
    of a ``record_function`` event of their name.  Empty without."""
    if not sessions or len(sessions) < 2:
        return []
    second = sessions[sorted(sessions)[1]]
    # the host spans that are record_functions (a readback is not)
    rf = ("server.preprocess", "server.collate", "server.rank")
    events = [(h[0], h[1]) for h in th.host if h[0] in rf]
    starts = [(s.name, s.start_ns * 1e-9) for s in second if s.name in rf]
    best = (0, 0.0)
    for nm, t in starts:
        for en, e in events:
            if en != nm:
                continue
            off = t - e
            hits = sum(any(en2 == nm2 and abs(t2 - off - e2) <= MATCH_S
                           for en2, e2 in events) for nm2, t2 in starts)
            if hits > best[0]:
                best = (hits, off)
    if not best[0]:
        return []
    return [(s.name, s.start_ns * 1e-9 - best[1],
             (s.end_ns or s.start_ns) * 1e-9 - best[1], s.ids.get("batch"))
            for s in second]


def named(ws: Dict, name: str) -> List[Dict]:
    return [s for s in ws["spans"] if s["name"] == name]


def _union(ivs) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(x, y) -> float:
    """Measure of the intersection of two unions of intervals."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        lo, hi = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        total += max(0.0, hi - lo)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_split(ctx: Dict) -> Optional[Dict[str, float]]:
    """The device-only window's idle time, in % of the window, split by
    where the server thread was: ``dispatch`` (inside ``server.dispatch``
    or a forward's span), ``host_work`` (inside preprocess, collate,
    readback or rank) and ``elsewhere``; the three sum to the window's
    idle share."""
    ws = window_spans(ctx)
    if ws is None:
        return None
    tr = ctx["trace"]
    if tr.window_s <= 0:
        return None
    busy = _union((s, e) for _, s, e in tr.device)
    idle, t = [], tr.start
    for a, b in busy:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if tr.end > t:
        idle.append((t, tr.end))
    idle = _union((max(a, tr.start), min(b, tr.end)) for a, b in idle)

    def cover(names):
        return _union((s["start"], s["end"]) for s in ws["spans"]
                      if s["name"] in names)
    in_dispatch = _overlap(idle, cover(DISPATCH))
    in_server = _overlap(idle, cover(DISPATCH + HOST_WORK))
    total = sum(b - a for a, b in idle)
    w = 100.0 / tr.window_s
    return {"dispatch": in_dispatch * w,
            "host_work": (in_server - in_dispatch) * w,
            "elsewhere": (total - in_server) * w}


def mean_device_ms(ctx: Dict, name: str) -> Optional[float]:
    """Mean stream milliseconds of session 1's spans ``name``."""
    ws = window_spans(ctx)
    if ws is None:
        return None
    ms = [s["device_ms"] for s in named(ws, name)
          if s["device_ms"] is not None]
    return sum(ms) / len(ms) if ms else None
