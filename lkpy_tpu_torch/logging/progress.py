"""
Progress reporting (port of ``lkpy_tpu/logging/progress.py``; reference:
src/lenskit/logging/progress/_dispatch.py:71).

:func:`item_progress` shows a Rich bar when standard error is a terminal
and Rich is installed, and reports nothing otherwise.  The JAX package's
Jupyter backend is not ported yet.
"""

from __future__ import annotations

import sys

__all__ = ["Progress", "item_progress", "set_progress_impl"]

_impl = "auto"


def set_progress_impl(name: str | None):
    """Select the progress backend: ``"rich"``, ``"none"`` or ``"auto"``
    (reference: progress/_dispatch.py:37); ``"notebook"``, the JAX
    package's Jupyter backend, reports nothing until it is ported."""
    global _impl
    _impl = name or "auto"


class Progress:
    """A progress bar handle that shows nothing (reference: progress/_base.py)."""

    def __init__(self, label: str, total: int | None = None, unit: str | None = None):
        self.label = label
        self.total = total
        self.completed = 0

    def update(self, advance: int = 1, **fields):
        self.completed += advance

    def finish(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


class _RichProgress(Progress):
    def __init__(self, label: str, total: int | None = None, unit: str | None = None):
        super().__init__(label, total, unit)
        from rich.progress import Progress as RP

        self._rp = RP(transient=True)
        self._rp.start()
        self._task = self._rp.add_task(label, total=total)

    def update(self, advance: int = 1, **fields):
        super().update(advance)
        self._rp.update(self._task, advance=advance)

    def finish(self):
        self._rp.stop()


def item_progress(label: str, total: int | None = None, unit: str | None = None) -> Progress:
    """A progress bar for processing items (reference: _dispatch.py:71)."""
    impl = _impl
    if impl == "auto" and sys.stderr.isatty():
        impl = "rich"
    if impl == "rich":
        try:
            return _RichProgress(label, total, unit)
        except ImportError:
            pass
    return Progress(label, total, unit)
