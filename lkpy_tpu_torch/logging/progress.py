"""
Progress reporting (port of ``lkpy_tpu/logging/progress.py``; reference:
src/lenskit/logging/progress/_dispatch.py:71).

:func:`item_progress` shows ipywidgets bars inside a Jupyter kernel (or
under ``"notebook"``, which :func:`~lkpy_tpu_torch.logging.
notebook_logging` selects; without ipywidgets it warns and reports
nothing), a Rich bar when standard error is a terminal and Rich is
installed, and reports nothing otherwise.
"""

from __future__ import annotations

import sys
import warnings
from contextlib import contextmanager
from typing import Iterator

__all__ = ["Progress", "item_progress", "item_progress_handle", "set_progress_impl"]

_impl = "auto"


def set_progress_impl(name: str | None):
    """Select the progress backend: ``"rich"``, ``"notebook"``, ``"none"``
    or ``"auto"`` (reference: progress/_dispatch.py:37)."""
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


class _JupyterProgress(Progress):
    """An ipywidgets bar (reference: progress/_notebook.py:26
    ``JupyterProgress``): an ``IntProgress`` and a completion label shown in
    the notebook, updated in place and marked ✓ on finish."""

    def __init__(self, label: str, total: int | None = None, unit: str | None = None):
        super().__init__(label, total, unit)
        import ipywidgets as widgets
        from IPython.display import display

        if total:
            self._bar = widgets.IntProgress(value=0, min=0, max=total)
        else:
            self._bar = widgets.IntProgress(value=1, min=0, max=1, bar_style="info")
        self._text = widgets.Label()
        self._box = widgets.HBox([widgets.Label(value=label), self._bar, self._text])
        display(self._box)

    def update(self, advance: int = 1, **fields):
        super().update(advance)
        if self.total:
            self._bar.value = self.completed
            self._text.value = f"{self.completed} / {self.total}"

    def finish(self):
        self._bar.bar_style = "success"
        self._text.value = "✓"


def _in_notebook() -> bool:
    """True inside a Jupyter kernel (a ZMQ shell)."""
    try:
        from IPython import get_ipython
    except ImportError:
        return False
    shell = get_ipython()
    return shell is not None and type(shell).__name__ == "ZMQInteractiveShell"


def item_progress(label: str, total: int | None = None, unit: str | None = None) -> Progress:
    """A progress bar for processing items (reference: _dispatch.py:71)."""
    impl = _impl
    if impl == "auto":
        if _in_notebook():
            impl = "notebook"
        elif sys.stderr.isatty():
            impl = "rich"
    if impl == "notebook":
        try:
            return _JupyterProgress(label, total, unit)
        except ImportError:
            warnings.warn("notebook progress backend needs ipywidgets", stacklevel=2)
    if impl == "rich":
        try:
            return _RichProgress(label, total, unit)
        except ImportError:
            pass
    return Progress(label, total, unit)


@contextmanager
def item_progress_handle(label: str, total: int | None = None) -> Iterator[Progress]:
    """:func:`item_progress` as a context that finishes the bar on exit."""
    pb = item_progress(label, total)
    try:
        yield pb
    finally:
        pb.finish()
