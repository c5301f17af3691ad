"""idle_host_issue_ms (session and dispatch, the port's own spans against
the device trace): the device's idle time inside the port's session spans
(``session.run`` / ``session.run_batched``), less the idle while the host
blocked in a ``sync`` span and less ``idle_after_sync_ms``'s stretches,
over the window's completed calls: the device waiting for the host to
issue work. None without a trace or where the program records no spans
(``repro_torch.obs``, bench/harness/port_spans.py)."""
from bench.harness import port_spans


def read(ctx):
    if ctx.trace is None:
        return None
    w = port_spans.window(ctx)
    if w is None:
        return None
    return 1e3 * port_spans.idle_split(w, ctx.trace)["host_issue"] / w.calls
