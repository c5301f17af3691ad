"""kernels_per_call (device, device trace): the device operations
(kernels, copies and fills) the profiler saw in the window, over the
window's completed calls."""


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    return len(ctx.trace.ops) / len(ctx.calls)
