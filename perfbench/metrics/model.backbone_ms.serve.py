"""Mean stream ms a forward of the program's ``model.backbone`` span: the
voxel encoder (``SegVoxelEncoder`` / ``Res16UNet``) without its maps,
between two CUDA events on the forward's stream, over the forwards of the
device-only traced window's session (``perfbench/spans.py``).  A stream
span holds all the work enqueued in it and the time the stream waited for
that work to be launched: in a launch-bound forward it is more than its
kernels' time."""
from perfbench.spans import mean_device_ms


def read(ctx):
    return mean_device_ms(ctx, "model.backbone")
