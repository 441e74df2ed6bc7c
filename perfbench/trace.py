"""The traced windows: torch.profiler reduced to the device's intervals,
the host's operators and the breakdown.

A traced run profiles twice.  The first window records the device's
activity alone (no host operator, no shapes), so the host runs as it
does untraced: its busy time, kernels and top operations are what the
device metrics read.  The second records the host's operators with
their input shapes as well, for what needs them (the calls of a kernel
and their shapes, the labels of idle gaps); its host runs slower under
the profiler, so its gaps are longer than untraced ones.

The busy time is the union of the device's intervals (the arithmetic of
``chip_smoke.profile_run``, copied): kernels, copies and sets alike.  The
window runs from the profiler's start to its stop, on the profiler's
clock (event times count from its start).  An idle gap is a stretch
between two device intervals; it is labelled by the innermost host
operator running at its middle.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class Trace:
    """Times in seconds on the profiler's clock."""
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float, list]] = field(default_factory=list)
    start: float = 0.0
    end: float = 0.0

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def kernels(self) -> List[Tuple[str, float, float]]:
        """The device intervals that are kernels (not copies or sets)."""
        return [d for d in self.device
                if not d[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        busy, end = 0.0, -math.inf
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            busy += max(0.0, e - max(s, end))
            end = max(end, e)
        return busy

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k[:200], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        ivs = sorted((s, e) for _, s, e in self.device)
        gaps, end = [], self.start
        for s, e in ivs:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.end > end:
            gaps.append((end, self.end))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            inner = [h for h in self.host if h[1] <= mid <= h[2]]
            label = max(inner, key=lambda h: h[1])[0] if inner \
                else "no operator (Python on the host)"
            out.append([label[:200], b - a])
        return out


def start_profiler(host: bool):
    """A started profiler of the device's activity, and with ``host`` of
    the host's operators with their input shapes too (on a host with no
    card, of the host's operators alone)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if host or not acts:
        acts.insert(0, ProfilerActivity.CPU)
    prof = profile(activities=acts, record_shapes=host)
    prof.start()
    return prof


def reduce(prof, seconds: float) -> Trace:
    """The stopped profiler's events, kept ``seconds`` after its start,
    as a ``Trace`` starting at 0."""
    import torch
    tr = Trace(start=0.0, end=seconds)
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        s = max(e.time_range.start * 1e-6, 0.0)
        t = min(e.time_range.end * 1e-6, seconds)
        if t <= s:
            continue
        if e.device_type == cuda:
            tr.device.append((e.name, s, t))
        else:
            tr.host.append((e.name, s, t, list(e.input_shapes or [])))
    return tr


def host_ops(tr: Trace, name: str) -> List[Tuple[float, list]]:
    """(start, input shapes) of each host operator ``name``, in order."""
    return sorted((h[1], h[3]) for h in tr.host if h[0] == name)


def kernel_times(tr: Trace, fragment: str) -> List[float]:
    """Seconds of each kernel whose name holds ``fragment``."""
    return [e - s for n, s, e in tr.kernels() if fragment in n]
