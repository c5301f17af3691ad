"""Spans and counters of the port's session path.

``span(name, **attrs)`` is a context manager that records one span: its
name, its start and end on ``time.perf_counter``, the span that encloses
it on the same thread (``parent``) and the id of the session call it
belongs to (``call``). A span with no parent on its thread is a root and
opens a new call id, which every span inside it shares. ``count(name,
n=1)`` adds to a counter. ``spans()``, ``counters()`` and ``reset()``
read and clear both.

Spans are recorded only while a ``torch.profiler`` window is open (torch's
``_is_profiler_enabled``, set for a profile of the device alone too) or
inside ``recording()``. Otherwise ``span`` returns one shared object that
does nothing. Counters are always on. At most ``MAX_SPANS`` spans are
kept; past that a span is dropped and the ``dropped`` counter rises.

The session path records these spans (PERF.md lists them with their
readers): ``session.run`` / ``session.run_batched`` (the roots),
``stack_ragged``, ``edge_terms``, ``lengths``, ``pack``, ``engine`` (the
kernel wrapper), ``check`` (an index check), ``launch``, ``head``,
``split``, and ``sync`` wherever the host blocks on the card: the read of
a CUDA value (``int()``), or a copy between host memory and the card,
which waits for the work queued ahead of it. Each ``sync`` span also adds
1 to the ``host_syncs`` counter, whether spans are recorded or not.

Operator note. To record without a profiler::

    from repro_torch import obs
    obs.reset()
    with obs.recording():
        session.run(stream)
    for s in obs.spans():
        print(s.call, s.name, s.parent, 1e3 * (s.end - s.start))

The clock is ``time.perf_counter``, the clock a caller times its calls on
and the one the benchmark maps the device trace onto
(``bench/harness/trace.py``), so a span and a device operation compare
directly.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch.autograd.profiler as _profiler

#: spans kept at most; the ``dropped`` counter counts the ones past it
MAX_SPANS = 1 << 17

_LOCK = threading.Lock()
_SPANS: list = []
_COUNTS: dict = {}
_IDS = itertools.count(1)
_CALLS = itertools.count(1)
#: each thread's stack of open spans
_LOCAL = threading.local()
#: open ``recording()`` blocks, on any thread
_RECORDING = 0


class Span:
    """One recorded span; times in seconds on ``time.perf_counter``."""

    __slots__ = ("name", "attrs", "id", "parent", "call", "start", "end")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, next(_CALLS)
        self.id = next(_IDS)
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        _LOCAL.stack.pop()
        with _LOCK:
            if len(_SPANS) < MAX_SPANS:
                _SPANS.append(self)
            else:
                _COUNTS["dropped"] = _COUNTS.get("dropped", 0) + 1
        return False


class _Off:
    """The span returned while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A span named ``name`` around a ``with`` block, recorded where a
    profiler window or ``recording()`` is open."""
    if _RECORDING or _profiler._is_profiler_enabled:
        return Span(name, attrs)
    return _OFF


def blocks(device) -> bool:
    """Does the host wait for ``device`` (a ``torch.device``, or None)
    where it reads a value from it or copies host memory to it? For a CUDA
    card; a CPU tensor's value is already there."""
    return device is not None and device.type == "cuda"


def sync(device, site: str):
    """The ``sync`` span of a place where the host blocks on ``device``,
    which counts in ``host_syncs``; nothing where ``blocks(device)`` is
    false. ``site`` names the place."""
    if not blocks(device):
        return _OFF
    count("host_syncs")
    return span("sync", site=site)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans inside the block, on every thread, with no profiler."""
    global _RECORDING
    with _LOCK:
        _RECORDING += 1
    try:
        yield
    finally:
        with _LOCK:
            _RECORDING -= 1


def spans() -> list:
    """The recorded spans, in the order they ended."""
    with _LOCK:
        return list(_SPANS)


def counters() -> dict:
    with _LOCK:
        return dict(_COUNTS)


def reset() -> None:
    """Forget every recorded span and every counter."""
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()
