"""
The traced run: the benchmark's spans and ``torch.profiler``'s device trace.

Spans are ``record_function`` ranges named ``portbench.<name>``, opened by
the benchmark's own files around each call into a layer (and, in a traced
run, around a few of the program's functions, wrapped from outside).
Untraced runs open none.  After the window the profiler's events are read
once into a :class:`Trace`: the device activities (kernels, copies, sets)
with their times, the host span each was launched from, and the spans.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import time
from dataclasses import dataclass, field

import torch

__all__ = ["Trace", "Tracer", "idle_percent", "wrap_spans"]

PREFIX = "portbench."


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    span: str | None  # the innermost span the host launched it from


@dataclass
class Trace:
    """What a traced window left: device activities and host spans, times in
    ns on the profiler's clock, and the window's host-clock bounds."""

    ops: list = field(default_factory=list)
    spans: list = field(default_factory=list)  # (name, start_ns, end_ns)
    window_start_ns: int = 0
    window_end_ns: int = 0

    @property
    def window_s(self) -> float:
        return (self.window_end_ns - self.window_start_ns) / 1e9

    def busy_s(self) -> float:
        """Seconds in which some device activity ran (overlaps counted once)."""
        total, end = 0, None
        for op in sorted(self.ops, key=lambda o: o.start_ns):
            lo, hi = op.start_ns, op.start_ns + op.dur_ns
            if end is None or lo > end:
                total += hi - lo
                end = hi
            elif hi > end:
                total += hi - end
                end = hi
        return total / 1e9

    def device_s(self, match=None, span: str | None = None) -> float:
        """Seconds of the activities whose name ``match`` accepts (all by
        default), launched from within ``span`` where given."""
        return sum(o.dur_ns for o in self.ops if (match is None or match(o.name)) and (span is None or o.span == span)) / 1e9

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0) + o.dur_ns
        return [[k[:200], v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time inside the window, summed by the span the
        host was in when each gap began (``outside spans`` where none)."""
        index = _SpanIndex(self.spans)
        by: dict[str, int] = {}
        end = self.window_start_ns
        for op in sorted(self.ops, key=lambda o: o.start_ns) + [DeviceOp("", self.window_end_ns, 0, None)]:
            if op.start_ns > end:
                label = index.at(end) or "outside spans"
                by[label] = by.get(label, 0) + op.start_ns - end
            end = max(end, op.start_ns + op.dur_ns)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_percent(r) -> float | None:
    """The per-layer reader of a device's idle share of the traced window,
    in %, for every cell (``r`` is the run's reading)."""
    busy = r.trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / r.trace.window_s)


class _SpanIndex:
    """Finds the innermost span holding a time: spans are well nested, so
    from the latest-starting span at or before ``t`` the walk goes up its
    parents until one still runs."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[1], -s[2]))
        self.starts = [s[1] for s in self.spans]
        self.parent, stack = [], []
        for i, (_, lo, hi) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][2] < lo:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: int) -> str | None:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][2] < t:
            i = self.parent[i]
        return self.spans[i][0] if i >= 0 else None


class Tracer:
    """Spans and the profiler of one run; with ``enabled`` false every
    method does nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self._t0 = self._t1 = 0

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = _now_ns()

    def stop(self) -> Trace | None:
        """End the trace and read it."""
        if not self.enabled:
            return None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._t1 = _now_ns()
        self._prof.__exit__(None, None, None)
        return _read(self._prof, self._t0, self._t1)


def _now_ns() -> int:
    # the profiler's events carry Unix time in ns
    return time.time_ns()


def _read(prof, t0: int, t1: int) -> Trace:
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    spans, launch_at, device, annotations = [], {}, [], set()
    for e in events:
        name = e.name()
        if e.device_type() == cpu:
            if e.is_user_annotation():
                annotations.add(name)
            if name.startswith(PREFIX):
                spans.append((name[len(PREFIX) :], e.start_ns(), e.start_ns() + e.duration_ns()))
            elif name.startswith(("cuda", "cu")) and e.correlation_id():
                # a runtime call: where the host launched a device activity
                launch_at[e.correlation_id()] = e.start_ns()
        elif name != "Activity Buffer Request" and not e.is_user_annotation():
            device.append(e)
    # a range of record_function (the benchmark's spans, torch's own) is
    # mirrored on the device's timeline; it is no activity of the device
    device = [e for e in device if e.name() not in annotations]
    index = _SpanIndex(spans)
    ops = []
    for e in device:
        at = launch_at.get(e.correlation_id())
        ops.append(DeviceOp(e.name(), e.start_ns(), e.duration_ns(), None if at is None else index.at(at)))
    return Trace(ops, spans, t0, t1)


def wrap_spans(tracer: Tracer, targets: list) -> contextlib.ExitStack:
    """Wrap the program's functions ``[module, attribute, span name]`` in
    spans for the traced run; closing the stack puts them back."""
    stack = contextlib.ExitStack()
    if not tracer.enabled:
        return stack
    for mod_name, attr, name in targets:
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            with tracer.span(_name):
                return _orig(*a, **kw)

        setattr(mod, attr, wrapped)
        stack.callback(setattr, mod, attr, orig)
    return stack
