"""
Key-value structured loggers over stdlib logging (port of
``lkpy_tpu/logging/logger.py``; reference: src/lenskit/logging/_proxy.py
``get_logger`` and logging/_config.py ``LoggingConfig``): loggers take
keyword arguments, rendered as ``key=value`` pairs (logfmt), and support
``.bind()``.
"""

from __future__ import annotations

import logging
import os
import sys
from dataclasses import dataclass
from pathlib import Path

__all__ = ["LKLogger", "LoggingConfig", "TRACE_LEVEL", "basic_logging", "get_logger", "notebook_logging"]

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


@dataclass
class LoggingConfig:
    """
    Logging setup (reference: src/lenskit/logging/_config.py ``LoggingConfig``).

    Supports console level, optional logfmt/JSON log files, and TRACE
    activation.
    """

    level: int = logging.INFO
    file: Path | None = None
    file_level: int | None = None
    json: bool = False

    def set_verbose(self, verbose: bool | int = True):
        if verbose:
            n = int(verbose)
            self.level = logging.DEBUG if n == 1 else TRACE_LEVEL

    def log_file(self, path: os.PathLike, level: int | None = None, json: bool = False):
        self.file = Path(path)
        self.file_level = level
        self.json = json

    def apply(self):
        root = logging.getLogger()
        root.setLevel(min(self.level, self.file_level or self.level))
        for h in list(root.handlers):
            root.removeHandler(h)
        try:
            from rich.logging import RichHandler

            console = RichHandler(show_path=False, log_time_format="[%X]")
        except ImportError:  # pragma: no cover
            console = logging.StreamHandler(sys.stderr)
            console.setFormatter(logging.Formatter("%(asctime)s %(levelname)-7s %(name)s %(message)s"))
        console.setLevel(self.level)
        root.addHandler(console)
        if self.file:
            fh = logging.FileHandler(self.file)
            if self.json:
                import json as _json

                class _JsonFmt(logging.Formatter):
                    def format(self, record):
                        return _json.dumps(
                            {
                                "ts": record.created,
                                "level": record.levelname,
                                "name": record.name,
                                "event": record.getMessage(),
                            }
                        )

                fh.setFormatter(_JsonFmt())
            else:
                fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)-7s %(name)s %(message)s"))
            fh.setLevel(self.file_level or self.level)
            root.addHandler(fh)


def basic_logging(level: int = logging.INFO):
    cfg = LoggingConfig(level=level)
    cfg.apply()


def notebook_logging(level: int = logging.INFO) -> None:
    """One-call logging + progress setup for notebooks
    (reference: logging/_config.py:66 ``notebook_logging``): applies a
    console logging config at ``level`` and selects the Jupyter progress
    backend."""
    from lkpy_tpu_torch.logging.progress import set_progress_impl

    cfg = LoggingConfig()
    cfg.level = level
    cfg.apply()
    set_progress_impl("notebook")
