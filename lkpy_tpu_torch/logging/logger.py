"""
Key-value structured loggers over stdlib logging (port of
``lkpy_tpu/logging/logger.py``; reference: src/lenskit/logging/_proxy.py
``get_logger``): loggers take keyword arguments, rendered as ``key=value``
pairs (logfmt), and support ``.bind()``.
"""

from __future__ import annotations

import logging

__all__ = ["LKLogger", "TRACE_LEVEL", "get_logger"]

TRACE_LEVEL = 5
logging.addLevelName(TRACE_LEVEL, "TRACE")


def _render_kv(kwargs: dict) -> str:
    if not kwargs:
        return ""
    parts = []
    for k, v in kwargs.items():
        s = str(v)
        if " " in s or "=" in s:
            s = repr(s)
        parts.append(f"{k}={s}")
    return " " + " ".join(parts)


class LKLogger:
    """A structlog-style bound logger wrapping :class:`logging.Logger`."""

    def __init__(self, logger: logging.Logger, context: dict | None = None):
        self._logger = logger
        self._context = context or {}

    def bind(self, **kwargs) -> "LKLogger":
        ctx = dict(self._context)
        ctx.update(kwargs)
        return LKLogger(self._logger, ctx)

    def unbind(self, *keys) -> "LKLogger":
        ctx = {k: v for k, v in self._context.items() if k not in keys}
        return LKLogger(self._logger, ctx)

    @property
    def name(self) -> str:
        return self._logger.name

    def _log(self, level: int, msg: str, *args, **kwargs):
        if self._logger.isEnabledFor(level):
            kv = dict(self._context)
            kv.update(kwargs)
            self._logger.log(level, msg + _render_kv(kv), *args, stacklevel=3)

    def trace(self, msg: str, *args, **kwargs):
        self._log(TRACE_LEVEL, msg, *args, **kwargs)

    def debug(self, msg: str, *args, **kwargs):
        self._log(logging.DEBUG, msg, *args, **kwargs)

    def info(self, msg: str, *args, **kwargs):
        self._log(logging.INFO, msg, *args, **kwargs)

    def warning(self, msg: str, *args, **kwargs):
        self._log(logging.WARNING, msg, *args, **kwargs)

    warn = warning

    def error(self, msg: str, *args, **kwargs):
        self._log(logging.ERROR, msg, *args, **kwargs)

    def exception(self, msg: str, *args, **kwargs):
        kv = dict(self._context)
        kv.update(kwargs)
        self._logger.exception(msg + _render_kv(kv), *args)

    def critical(self, msg: str, *args, **kwargs):
        self._log(logging.CRITICAL, msg, *args, **kwargs)

    def isEnabledFor(self, level: int) -> bool:
        return self._logger.isEnabledFor(level)


def get_logger(name: str, **initial: object) -> LKLogger:
    """Get a bound key-value logger (reference: logging/_proxy.py)."""
    return LKLogger(logging.getLogger(name), dict(initial))
