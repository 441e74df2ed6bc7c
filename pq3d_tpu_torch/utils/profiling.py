"""Profiling hooks (the JAX package's ``utils/profiling.py`` on
``torch.profiler``).

``StepProfiler`` traces a window of train steps on the schedule the JAX
package gives its ``jax.profiler`` trace (skip ``wait`` steps, capture
``active``), with the card's kernels when CUDA is there, and writes a
Chrome trace (``trace_rank{r}.json``, viewable in Perfetto or
``chrome://tracing``) into ``trace_dir``.  ``timed`` times a block on the
host clock.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


def start_trace():
    """A started ``torch.profiler.profile`` of the host and, when CUDA is
    there, the card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof, path: str) -> None:
    """Stop ``prof`` after the card's queued work and write its Chrome
    trace to ``path``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(path)


class StepProfiler:
    """Schedule-driven tracer: call ``step()`` once per train step; the
    trace starts before step ``wait`` runs (at the ``wait``-th call) and
    stops at call ``wait + active``, ``active`` steps later, as the JAX
    package's ``StepProfiler`` does; ``close()`` stops an open trace.
    Nothing happens unless ``enabled`` (the config's ``profile``)."""

    def __init__(self, trace_dir: str, wait: int = 10, active: int = 10,
                 enabled: bool = False, rank: int = 0):
        self.trace_dir = trace_dir
        self.wait = wait
        self.active = active
        self.enabled = enabled
        self.path = os.path.join(trace_dir, f"trace_rank{rank}.json")
        self._step = 0
        self._prof = None

    def step(self) -> None:
        if not self.enabled:
            return
        if self._step == self.wait and self._prof is None:
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof = start_trace()
        if self._step == self.wait + self.active and self._prof is not None:
            self.close()
            print(f"[profiler] trace written to {self.path}")
        self._step += 1

    def close(self) -> None:
        if self._prof is not None:
            stop_trace(self._prof, self.path)
            self._prof = None


@contextlib.contextmanager
def timed(name: str, sink: Optional[dict] = None) -> Iterator[None]:
    """Host seconds of the block, into ``sink[name]`` or printed."""
    t0 = time.time()
    yield
    dt = time.time() - t0
    if sink is not None:
        sink[name] = dt
    else:
        print(f"[timed] {name}: {dt:.3f}s")
