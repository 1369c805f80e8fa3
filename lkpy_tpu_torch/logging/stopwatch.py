"""Stopwatch timer (port of ``lkpy_tpu/logging/stopwatch.py``; reference:
src/lenskit/logging/_stopwatch.py).  Host wall-clock time: it does not wait
for the card."""

from __future__ import annotations

import time

__all__ = ["Stopwatch"]


class Stopwatch:
    """Wall-clock stopwatch; also usable as a context manager."""

    def __init__(self, start: bool = True):
        self.start_time: float | None = None
        self.stop_time: float | None = None
        if start:
            self.start()

    def start(self):
        self.start_time = time.perf_counter()
        self.stop_time = None

    def stop(self):
        self.stop_time = time.perf_counter()

    def elapsed(self) -> float:
        end = self.stop_time if self.stop_time is not None else time.perf_counter()
        return end - (self.start_time or end)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def __str__(self):
        e = self.elapsed()
        if e < 1:
            return f"{e * 1000:.0f}ms"
        if e < 60:
            return f"{e:.2f}s"
        m, s = divmod(e, 60)
        return f"{int(m)}m{s:.1f}s"
