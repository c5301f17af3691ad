"""idle_after_sync_ms (session and dispatch, the port's own spans against
the device trace): for each of the port's ``sync`` spans in the window,
the device's idle time from the span's end to the next device operation,
inside the port's session spans (the union, so no stretch counts twice),
over the window's completed calls: the idle that removing the syncs would
recover. None without a trace or where the program records no spans
(``repro_torch.obs``, bench/harness/port_spans.py)."""
from bench.harness import port_spans


def read(ctx):
    if ctx.trace is None:
        return None
    w = port_spans.window(ctx)
    if w is None:
        return None
    return 1e3 * port_spans.idle_split(w, ctx.trace)["after_sync"] / w.calls
