"""Serving. The LM scaffold's greedy decode is ported (``lm_serve``); the
DGNN serve layer (SnapshotServer, supervision, the scheduler and the state
pool) is not yet (ROADMAP queue 1, the serve layer)."""
from repro_torch.serve.lm_serve import generate, make_serve_step

__all__ = ["generate", "make_serve_step"]
