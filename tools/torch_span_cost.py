"""The cost of the recorder's spans (``pq3d_tpu_torch/utils/profiling``)
on the card's host, and the clock they share with the profiler.

    python tools/torch_span_cost.py [--calls 100000]

Prints one JSON line:

- ``ns_per_call``: ns a call of ``span``, ``device_span`` (timed on the
  card's current stream), ``device_span`` given no device (the server's
  dispatch and readback, untimed) and ``count``, each over ``--calls``
  calls, with no
  profiler running (``off``), under a profiler of the device's activity
  alone (``on_device``, as the benchmark's first traced window) and under
  one of the host's operators as well (``on_host``);
- ``clock``: ``time.time_ns()`` read before and after the profiler's
  start against its ``trace_start_ns()``, the ns from each synchronising
  copy's end on the trace to the end of the ``device_span`` around it,
  and the window start ``perfbench/spans.align`` recovers from those copies
  against the profiler's own.

Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from pq3d_tpu_torch.utils import profiling  # noqa: E402


def per_call(fn, calls: int) -> float:
    for _ in range(1000):
        fn()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter_ns() - t0) / calls


def costs(calls: int) -> dict:
    dev = torch.device("cuda")
    torch.cuda.synchronize()    # the context, outside every timing

    def sp():
        with profiling.span("server.rank", batch=1, requests=(1, 2)):
            pass

    def dsp():
        with profiling.device_span("model.maps", dev):
            pass

    def untimed():
        with profiling.device_span("server.dispatch", batch=1,
                                   requests=(1, 2)):
            pass

    def cnt():
        profiling.count("server.hold", 0.5, batch=1)
    out = {}
    for mode, acts in (("off", None),
                       ("on_device", [ProfilerActivity.CUDA]),
                       ("on_host", [ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])):
        prof = profile(activities=acts) if acts else None
        if prof is not None:
            prof.start()
        out[mode] = {name: per_call(fn, calls) for name, fn in
                     (("span", sp), ("device_span", dsp),
                      ("device_span_untimed", untimed), ("count", cnt))}
        if prof is not None:
            prof.stop()
        profiling.clear()
    return out


def clock() -> dict:
    from perfbench.spans import align
    x = torch.randn(4, 120, 512, device="cuda")
    prof = profile(activities=[ProfilerActivity.CUDA])
    t0 = time.time_ns()
    prof.start()
    t1 = time.time_ns()
    ends = []
    for _ in range(20):
        y = x * 2
        with profiling.device_span("server.readback", "cuda") as s:
            y.cpu().numpy()
        ends.append(s.end_ns)
        time.sleep(0.01)
    prof.stop()
    start = prof.profiler.kineto_results.trace_start_ns()
    copies = sorted(e.time_range.end * 1e3 for e in prof.events()
                    if e.name.startswith("Memcpy DtoH"))
    lags = [min((e - start) - c for c in copies if (e - start) >= c)
            for e in ends]
    off, rate, gaps = align([(e - ends[0]) * 1e-9 for e in ends],
                      [c * 1e-9 for c in copies])
    profiling.clear()
    return {"trace_start_minus_before_ns": start - t0,
            "after_minus_trace_start_ns": t1 - start,
            "readback_end_after_copy_ns": lags,
            "copies": len(copies), "matched": len(gaps), "rate": rate,
            "aligned_start_minus_trace_start_ns":
                round(ends[0] + off / (1 - rate) * 1e9 - start)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--calls", type=int, default=100_000)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_span_cost: needs a card", file=sys.stderr)
        return 2
    import torch.autograd.profiler as ap
    line = {"device": torch.cuda.get_device_name(0),
            "torch": torch.__version__,
            "profiler_flag": type(ap._is_profiler_enabled).__name__,
            "ns_per_call": costs(args.calls), "clock": clock()}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
