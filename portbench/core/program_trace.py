"""
The program's own spans and counters in a traced run.

The program under test records its ``lkt.*`` spans and its counters while
the profiler records (``lkpy_tpu_torch.logging``: ``spans()``, ``counts()``),
on ``time.time_ns()``, the clock of the traced window's bounds.  The readers
here take the spans that lie inside the window, and attribute the device's
idle gaps to the innermost program span open where each gap began, with the
walk of :meth:`~portbench.core.trace.Trace.idle_gaps` (its ``_SpanIndex``)
over the program's spans in place of the benchmark's.  Where the trace holds
no device activity, or the program records no spans, they return ``None``.
"""

from __future__ import annotations

from portbench.core.trace import Trace

__all__ = ["counter", "idle_percent_in", "mean_s", "window_spans"]


def _store():
    """The program's span store, or None where the program has none."""
    try:
        from lkpy_tpu_torch import logging as store
    except ImportError:
        return None
    return store if hasattr(store, "spans") and hasattr(store, "counts") else None


def window_spans(r) -> list | None:
    """``(name, start_ns, end_ns)`` of each program span inside the traced
    window; None without device activity or without the program's store."""
    store = _store()
    if store is None or not r.trace.ops:
        return None
    lo, hi = r.trace.window_start_ns, r.trace.window_end_ns
    return [(s.name, s.start_ns, s.end_ns) for s in store.spans() if lo <= s.start_ns and s.end_ns <= hi]


def mean_s(r, name: str) -> float | None:
    """The mean seconds of the program's spans ``name`` in the window."""
    durations = [hi - lo for n, lo, hi in window_spans(r) or () if n == name]
    return sum(durations) / len(durations) / 1e9 if durations else None


def idle_percent_in(r, match) -> float | None:
    """The device's idle time whose gap began inside a program span whose
    name ``match`` accepts (the innermost one open then), in % of the
    traced window."""
    spans = window_spans(r)
    if not spans:
        return None
    t = r.trace
    gaps = Trace(t.ops, spans, t.window_start_ns, t.window_end_ns).idle_gaps(len(spans) + 1)
    return 100.0 * sum(s for label, s in gaps if match(label)) / t.window_s


def counter(r, name: str) -> int | None:
    """The program's counter ``name``: what it added while the profiler
    recorded, which is the traced window.  None without device activity."""
    store = _store()
    if store is None or not r.trace.ops:
        return None
    return store.counts().get(name)
