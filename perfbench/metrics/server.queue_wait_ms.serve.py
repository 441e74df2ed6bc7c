"""Mean queue wait of a request, in ms: the program's ``server.queue_wait``
counters (submit to the start of its batch's host work, one a request)
of the requests dispatched in the device-only traced window's session
(``perfbench/spans.py``)."""
from perfbench.spans import named, window_spans


def read(ctx):
    ws = window_spans(ctx)
    waits = [s["value"] for s in named(ws, "server.queue_wait")] if ws \
        else []
    return 1e3 * sum(waits) / len(waits) if waits else None
