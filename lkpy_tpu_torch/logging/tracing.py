"""
TRACE-level tracing (port of ``lkpy_tpu/logging/tracing.py``; reference:
src/lenskit/logging/_tracing.py:51,91).

``trace(log, ...)`` does nothing unless tracing has been activated, which
keeps the pipeline runner's inner loop cheap.
"""

from __future__ import annotations

import logging

from lkpy_tpu_torch.logging.logger import TRACE_LEVEL, LKLogger

__all__ = ["trace", "activate_tracing", "tracing_active", "Tracer"]

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
