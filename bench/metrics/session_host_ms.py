"""session_host_ms (session and dispatch, the benchmark's own span): the
mean over the window's calls of the host time from the call into the
session to its return, before the benchmark synchronises. It holds the
host work of stacking, packing and launching, and the waits of the index
checks, each of which synchronises with the device."""


def read(ctx):
    if not ctx.calls:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, *_ in ctx.calls) / len(ctx.calls)
