"""Profiling hooks (the JAX package's ``utils/profiling.py`` on
``torch.profiler``) and the program's recorder of spans and counters.

``StepProfiler`` traces a window of train steps on the schedule the JAX
package gives its ``jax.profiler`` trace (skip ``wait`` steps, capture
``active``), with the card's kernels when CUDA is there, and writes a
Chrome trace (``trace_rank{r}.json``, viewable in Perfetto or
``chrome://tracing``) into ``trace_dir``.

The recorder keeps spans at the program's layer boundaries while a
``torch.profiler`` runs in the process (``StepProfiler``'s, or any
other), and nothing otherwise:

- ``span(name, **ids)``: a block of host work, also a
  ``torch.profiler.record_function`` so the profiler's host timeline
  names it;
- ``device_span(name, device=None, **ids)``: a block that enqueues work
  on a device; no ``record_function`` (the profiler would put an
  annotation of the device's type over the device work it enqueued), and,
  given a CUDA ``device`` (for a region whose stream time is read), a
  pair of timing events on the device's current stream, whose
  milliseconds (``Span.device_ms``) are read once both have run, never by
  synchronising;
- ``count(name, value, **ids)``: a counter, a span of no duration that
  holds a value.

With no profiler running a span costs one test of the profiler's own
flag and one store (the session count's mark), and returns a shared
no-op context; under ``torch.compile`` and
``torch.export`` it is a no-op too.  A span holds its name, its start and
end in ns on ``time.time_ns()`` (the clock the profiler stamps its events
on), its thread, its parent (the innermost span open on that thread) and
the ids it was given (a batch, the requests a batch holds).  Spans are
kept in a bounded buffer, grouped into sessions: a session starts at the
first span that sees a profiler after one that saw none.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


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


# ---------------------------------------------------------------------------
# the recorder

class Span:
    """One recorded span or counter (``value`` set, ``start_ns ==
    end_ns``).  ``end_ns`` is None while the span is open."""

    __slots__ = ("id", "name", "session", "thread", "parent", "ids",
                 "start_ns", "end_ns", "value", "_rf", "_events",
                 "_stream", "_ms")

    def __init__(self, name: str, ids: Dict[str, Any], session: int,
                 host: bool = False, stream=None):
        self.id = 0
        self.name = name
        self.ids = ids
        self.session = session
        self.thread = threading.get_ident()
        self.parent: Optional[int] = None
        self.start_ns = self.end_ns = 0
        self.value: Optional[float] = None
        self._rf = torch.profiler.record_function(name) if host else None
        self._stream = stream
        self._events = None
        self._ms: Optional[float] = None

    def __enter__(self) -> "Span":
        stack = RECORDER.stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        RECORDER.add(self)
        if self._rf is not None:
            self._rf.__enter__()
        if self._stream is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        self.end_ns = None
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record(self._stream)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        stack = RECORDER.stack()
        if stack and stack[-1] is self:
            stack.pop()

    @property
    def device_ms(self) -> Optional[float]:
        """Stream milliseconds between the span's two events, once the
        device has run both (None before, and for a span with none)."""
        if self._ms is None and self._events is not None \
                and self._events[1].query():
            self._ms = self._events[0].elapsed_time(self._events[1])
        return self._ms


class Recorder:
    """The bounded buffer of spans, and the session count: a session
    starts at the first span that sees a profiler after one that saw
    none (``saw_off``, set by the off path)."""

    def __init__(self, limit: int = 100_000):
        self.spans: deque = deque(maxlen=limit)
        self.session = 0
        self.saw_off = True
        self._ids = itertools.count(1)
        self._local = threading.local()

    def stack(self) -> List[Span]:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def current_session(self) -> int:
        if self.saw_off:
            self.saw_off = False
            self.session += 1
        return self.session

    def add(self, sp: Span) -> None:
        sp.id = next(self._ids)
        self.spans.append(sp)

    def sessions(self) -> Dict[int, List[Span]]:
        """The kept spans by session, each in the order they started."""
        out: Dict[int, List[Span]] = {}
        for sp in list(self.spans):
            out.setdefault(sp.session, []).append(sp)
        return out

    def clear(self) -> None:
        self.spans.clear()
        self.session = 0
        self.saw_off = True


RECORDER = Recorder()
_NOOP = contextlib.nullcontext()


def _session() -> int:
    """The session a span begun now belongs to, or 0 when it records
    nothing: no profiler runs (noted, so that the next one starts a
    session), or torch.compile or torch.export is tracing the program."""
    if not _autograd_profiler._is_profiler_enabled:
        RECORDER.saw_off = True
        return 0
    if torch.compiler.is_compiling():
        return 0
    return RECORDER.current_session()


def span(name: str, **ids):
    """A recorded span of host work (and a ``record_function``) while a
    profiler runs; otherwise a shared no-op context."""
    session = _session()
    return Span(name, ids, session, host=True) if session else _NOOP


def device_span(name: str, device=None, **ids):
    """A recorded span of a block that enqueues work on ``device``, timed
    on its current stream as well when it is a CUDA device, while a
    profiler runs; otherwise a shared no-op context."""
    session = _session()
    if not session:
        return _NOOP
    stream = None
    if device is not None and torch.device(device).type == "cuda":
        stream = torch.cuda.current_stream(device)
    return Span(name, ids, session, stream=stream)


def count(name: str, value: float, **ids) -> None:
    """A counter, recorded while a profiler runs."""
    session = _session()
    if not session:
        return
    sp = Span(name, ids, session)
    stack = RECORDER.stack()
    sp.parent = stack[-1].id if stack else None
    sp.start_ns = sp.end_ns = time.time_ns()
    sp.value = float(value)
    RECORDER.add(sp)


def sessions() -> Dict[int, List[Span]]:
    """The recorder's kept spans by session (1, 2, ...)."""
    return RECORDER.sessions()


def clear() -> None:
    """Forget every kept span; the next session is 1 again."""
    RECORDER.clear()
