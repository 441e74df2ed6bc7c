"""Mean stream ms a forward of the program's ``model.maps`` span: the
U-Net's maps built on the card (``ops/device_maps.build_batch_maps``),
between two CUDA events on the forward's stream, over the forwards of the
device-only traced window's session (``perfbench/spans.py``).  A stream
span holds all the work enqueued in it and the time the stream waited for
that work to be launched: in a launch-bound forward it is more than its
kernels' time."""
from perfbench.spans import mean_device_ms


def read(ctx):
    return mean_device_ms(ctx, "model.maps")
