"""Share of the card's dense bf16 peak: the operations the window's
answered requests needed (``perfbench/count``, from their shapes) over
the window's seconds times the published peak."""
from perfbench.count.roofline import peaks_for


def read(ctx):
    flops, seconds = ctx.get("flops"), ctx.get("seconds")
    peaks = peaks_for(ctx.get("device_name", ""))
    if not flops or not seconds or peaks is None:
        return None
    return 100.0 * flops / (seconds * peaks[0])
