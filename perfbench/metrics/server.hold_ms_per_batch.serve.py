"""Mean hold of a batch, in ms: the program's ``server.hold`` counters
(the end of its ``server.dispatch`` to the start of its
``server.readback``: the time its answers wait for the server thread) of
the batches whose dispatch span the device-only traced window's session
holds (``perfbench/spans.py``)."""
from perfbench.spans import named, window_spans


def read(ctx):
    ws = window_spans(ctx)
    if ws is None:
        return None
    batches = {s["ids"].get("batch") for s in named(ws, "server.dispatch")}
    holds = [s["value"] for s in named(ws, "server.hold")
             if s["ids"].get("batch") in batches]
    return 1e3 * sum(holds) / len(holds) if holds else None
