"""stream_ms_p95 (end to end, host clock): the 95th percentile, over every
call completed in the window, of one call's wall time from the call into
the session to its outputs synchronised."""
from bench.harness.stats import percentile


def read(ctx):
    if not ctx.calls:
        return None
    return 1e3 * percentile([t2 - t0 for t0, _, t2, *_ in ctx.calls], 95)
