"""Share of the device-only traced window in which the device is idle
while the server thread is inside ``server.dispatch`` (the host-to-device
copy and the forward's launches; a forward's ``model.*`` spans count as
inside it): the card waiting on launches.  With
``device.idle_in_host_work.serve`` and ``device.idle_elsewhere.serve`` it
partitions ``device.idle_share.serve`` (``perfbench/spans.idle_split``)."""
from perfbench.spans import idle_split


def read(ctx):
    split = idle_split(ctx)
    return split["dispatch"] if split else None
