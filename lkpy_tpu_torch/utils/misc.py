"""Misc utilities (port of ``lkpy_tpu/utils/misc.py``; reference:
src/lenskit/util/ — Latch, indent helpers)."""

from __future__ import annotations

import textwrap
import threading

__all__ = ["Latch", "indent_lines"]


class Latch:
    """A count-down latch for coordinating threads (reference: util Latch)."""

    def __init__(self, count: int = 1):
        self._count = count
        self._cond = threading.Condition()

    def count_down(self):
        with self._cond:
            if self._count > 0:
                self._count -= 1
            if self._count == 0:
                self._cond.notify_all()

    def wait(self, timeout: float | None = None) -> bool:
        with self._cond:
            if self._count == 0:
                return True
            return self._cond.wait_for(lambda: self._count == 0, timeout)


def indent_lines(text: str, prefix: str = "  ") -> str:
    return textwrap.indent(text, prefix)
