"""host_syncs_per_call (session and dispatch, the port's own spans): the
port's ``sync`` spans in the window (each a place where the host blocked
on the card: the read of a CUDA value, or a copy from host memory that
waits for the work queued ahead of it) over the window's completed calls.
The spans are on for the whole traced window, so their count is the
increase of the port's ``host_syncs`` counter. None where the program
records no spans (``repro_torch.obs``, bench/harness/port_spans.py)."""
from bench.harness import port_spans


def read(ctx):
    w = port_spans.window(ctx)
    if w is None:
        return None
    return len(w.syncs) / w.calls
