"""Share of the device-only traced window in which the device is idle
while the server thread is inside none of its stage spans: waits for
requests, the loop's own Python, the clients' callbacks run on it, and a
dispatch entered before the window's profiler started, where it is not
inside a forward's span (``perfbench/spans.idle_split``)."""
from perfbench.spans import idle_split


def read(ctx):
    split = idle_split(ctx)
    return split["elsewhere"] if split else None
