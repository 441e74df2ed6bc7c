"""Share of the traced window in which no operation ran on the device:
the window minus the union of the device's intervals, over the window."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
