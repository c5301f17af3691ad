"""device_idle_share (device, device trace): the share of the traced
window in which no operation (kernel, copy or fill) ran on the device:
1 - (union of their intervals) / window."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
