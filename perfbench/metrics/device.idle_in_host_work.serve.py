"""Share of the device-only traced window in which the device is idle
while the server thread is inside ``server.preprocess``,
``server.collate``, ``server.readback`` or ``server.rank``: the card
waiting on the server's host work (``perfbench/spans.idle_split``)."""
from perfbench.spans import idle_split


def read(ctx):
    split = idle_split(ctx)
    return split["host_work"] if split else None
