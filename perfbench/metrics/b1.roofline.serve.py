"""Kernel B1's share of its roofline in the second traced window (the one
with the host's operators and their shapes).

Each call of the op ``pq3d::zrun_conv`` has the bound of
``count/roofline.conv_bound`` over the real rows of the forward it runs
in: its level is the one whose padded rows (batch times the level's cap)
it was given; its operations count the valid 3^3 references of the real
voxels of that forward's scenes at that level; its bytes count reading
those rows of x (bf16), W (bf16) and their z-run plan once and writing
their rows of y (f32) once.  The share is the mean bound a call times
the B1 kernels traced, over their summed device time (at the window's
edges a call and its kernel can fall on either side of it).  Nothing is
read where the window holds no call or no kernel, or a call's rows are
no level's.
"""
from bisect import bisect_right

from perfbench.count.roofline import conv_bound, peaks_for, zrun_plan_bytes
from perfbench.trace import host_ops, kernel_times

OP = "pq3d::zrun_conv"
KERNEL = "zrun_conv_kernel"


def read(ctx):
    tr, fwds = ctx.get("trace_host"), ctx.get("host_forwards")
    if tr is None or not fwds:
        return None
    calls = host_ops(tr, OP)
    times = kernel_times(tr, KERNEL)
    peaks = peaks_for(ctx.get("device_name", ""))
    if not calls or not times or peaks is None:
        return None
    flops_peak, bw_peak = peaks
    padded = [ctx["batch"] * c for c in ctx["level_caps"]]
    starts = [f["start"] for f in fwds]
    bound_ms = 0.0
    for t, shapes in calls:
        (n, cin), (_, _, cout) = shapes[0], shapes[1]
        k = bisect_right(starts, t) - 1
        if n not in padded or k < 0:
            return None
        level = padded.index(n)
        rows = fwds[k]["n"][level]
        with_valid = len(shapes) > 4 and bool(shapes[4])
        bound_ms += conv_bound(rows, cin, cout, fwds[k]["pairs3"][level],
                               zrun_plan_bytes(rows, with_valid), flops_peak,
                               bw_peak, x_bytes=2)[0]
    # one kernel a call at these widths (one column slice)
    return 100.0 * bound_ms / len(calls) * len(times) / (sum(times) * 1e3)
