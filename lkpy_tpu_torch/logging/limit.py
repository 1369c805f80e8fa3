"""
Warning deduplication and rate limiting (port of
``lkpy_tpu/logging/limit.py``; reference: src/lenskit/logging/_warnings.py,
_limit.py).
"""

from __future__ import annotations

import time
import warnings
from collections import defaultdict

__all__ = ["RateLimitedWarnings", "filter_duplicate_warnings"]


class RateLimitedWarnings:
    """Suppress repeats of the same warning within a time window."""

    def __init__(self, window: float = 30.0):
        self.window = window
        self._last: dict[str, float] = defaultdict(float)

    def warn(self, message: str, category: type[Warning] = UserWarning, *, stacklevel: int = 2):
        now = time.monotonic()
        key = f"{category.__name__}:{message}"
        if now - self._last[key] >= self.window:
            self._last[key] = now
            warnings.warn(message, category, stacklevel=stacklevel + 1)


def filter_duplicate_warnings(action: str = "once"):
    """Install a 'once' filter for the port's warning categories."""
    from lkpy_tpu_torch.diagnostics import ConfigWarning, DataWarning, PipelineWarning

    for cat in (DataWarning, ConfigWarning, PipelineWarning):
        warnings.filterwarnings(action, category=cat)
