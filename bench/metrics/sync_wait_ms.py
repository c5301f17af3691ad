"""sync_wait_ms (session and dispatch, the port's own spans on the host
clock): the host time inside the port's ``sync`` spans, summed over the
window and divided by its completed calls: the part of
``session_host_ms`` that waits for the card rather than works. None where
the program records no spans (``repro_torch.obs``,
bench/harness/port_spans.py)."""
from bench.harness import port_spans


def read(ctx):
    w = port_spans.window(ctx)
    if w is None:
        return None
    return 1e3 * sum(e - s for s, e in w.syncs) / w.calls
