"""engine_roofline (kernels, device trace): the least time the card could
take for the window's engine work, the larger of its operations over the
fp32 peak and its bytes over the HBM peak (the benchmark's own count of
its inputs, bench/work/<config>.py), over the engine kernels' summed
device time in the trace. None where the trace saw no engine kernel or
the card has no entry in the peaks table."""
from bench.harness.peaks import least_seconds


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    kernel = ctx.config["engine"]["kernel"]
    busy = sum(e - s for name, _, s, e in ctx.trace.ops if kernel in name)
    if busy <= 0:
        return None
    least = least_seconds(ctx.totals["engine_flops"],
                          ctx.totals["engine_bytes"], ctx.peaks)
    return 100.0 * least / busy
