"""
TRACE-level tracing (port of ``lkpy_tpu/logging/tracing.py``; reference:
src/lenskit/logging/_tracing.py:51,91), and the program's spans and
counters.

``trace(log, ...)`` does nothing unless tracing has been activated, which
keeps the pipeline runner's inner loop cheap.

``span(name)`` times a piece of the program's work and ``count(name, n)``
adds to a counter.  Both record only while a ``torch.profiler`` session
records or inside a :func:`record_spans` block; otherwise ``span`` returns
one shared object that does nothing and ``count`` returns at once, after a
single test, with no clock read, allocation or device sync.  A recorded span
keeps its name, its start and end on ``time.time_ns()`` (the clock of the
profiler's events), the index of the span that encloses it on its thread
and the request it served, in a bounded store that drops its oldest entries
once full and counts them.  While a profiler records, each span also opens a
``record_function`` range of the same name, so an exported profile shows
the program's spans on the device's timeline.  Span names start with
``lkt.``; :func:`spans`, :func:`counts` and :func:`take_spans` read them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import threading
import time
from typing import NamedTuple

import torch

from lkpy_tpu_torch.logging.logger import TRACE_LEVEL, LKLogger

__all__ = [
    "SpanRecord",
    "Tracer",
    "activate_tracing",
    "count",
    "counts",
    "dropped_spans",
    "new_request",
    "record_spans",
    "span",
    "spans",
    "take_spans",
    "trace",
    "tracing_active",
]

_active = False


def activate_tracing(active: bool = True):
    global _active
    _active = active
    if active:
        logging.getLogger().setLevel(TRACE_LEVEL)


def tracing_active() -> bool:
    return _active


def trace(log: LKLogger, msg: str, *args, **kwargs):
    """Emit a TRACE-level message if tracing is active (reference: _tracing.py:51)."""
    if _active:
        log.trace(msg, *args, **kwargs)


class Tracer:
    """Bound tracer for a logger (reference: _tracing.py ``get_tracer``)."""

    def __init__(self, log: LKLogger):
        self._log = log

    def trace(self, msg: str, *args, **kwargs):
        trace(self._log, msg, *args, **kwargs)

    def add_bindings(self, **kwargs):
        self._log = self._log.bind(**kwargs)


# ---- spans and counters ------------------------------------------------------

#: the most spans the store keeps; older ones are dropped and counted
SPAN_STORE = 1 << 17


class SpanRecord(NamedTuple):
    """One recorded span: times in ns on ``time.time_ns()``; ``parent`` is
    the ``index`` of the span that enclosed it on its thread (-1 at the
    top); ``request`` the serving request it belongs to, if any."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    request: int | None
    index: int


_profiling = torch._C._autograd._profiler_enabled
_recording = 0  # open record_spans() blocks
_lock = threading.Lock()
_store: collections.deque = collections.deque(maxlen=SPAN_STORE)
_dropped = 0
_counts: dict[str, int] = {}
_indices = itertools.count()
_requests = itertools.count(1)
_open = threading.local()  # .index: the innermost open span on this thread


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    """A span that reads the clock; ``recorded`` ones enter the store.
    ``seconds`` is its duration once it has closed."""

    __slots__ = ("name", "request", "recorded", "start_ns", "end_ns", "index", "parent", "_range")

    def __init__(self, name: str, request: int | None, recorded: bool):
        self.name = name
        self.request = request
        self.recorded = recorded
        self._range = None

    def __enter__(self):
        if self.recorded:
            self.index = next(_indices)
            self.parent = getattr(_open, "index", -1)
            _open.index = self.index
            if _profiling():
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.recorded:
            if self._range is not None:
                self._range.__exit__(*exc)
            _open.index = self.parent
            _keep((self.name, self.start_ns, self.end_ns, self.parent, self.request, self.index))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _keep(rec: tuple) -> None:
    # a plain tuple of atomic values: the collector stops tracking it, so a
    # full store adds nothing to the collections of a large process
    global _dropped
    with _lock:
        if len(_store) == _store.maxlen:
            _dropped += 1
        _store.append(rec)


def span(name: str, *, request: int | None = None, timed: bool = False):
    """A context manager around a piece of the program's work, recorded
    while a profiler records or inside :func:`record_spans`.  ``timed``
    asks for its clock reads even when spans do not record, for a caller
    that reads ``.seconds`` after the block; one measurement then feeds
    both."""
    if _recording or _profiling():
        return _Span(name, request, True)
    return _Span(name, request, False) if timed else _NO_SPAN


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while spans record."""
    if _recording or _profiling():
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def record_spans():
    """Record spans and counters in the block without a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> list[SpanRecord]:
    """The recorded spans, in the order they closed; the store is kept."""
    with _lock:
        return [SpanRecord._make(r) for r in _store]


def take_spans() -> list[SpanRecord]:
    """The recorded spans, clearing the store and its count of drops."""
    global _dropped
    with _lock:
        out = [SpanRecord._make(r) for r in _store]
        _store.clear()
        _dropped = 0
    return out


def dropped_spans() -> int:
    """How many spans the full store dropped since it was last taken."""
    return _dropped


def counts() -> dict[str, int]:
    """The counters' totals since the process started."""
    with _lock:
        return dict(_counts)


def new_request() -> int:
    """A process-wide request id, for the spans of one serving call."""
    return next(_requests)
