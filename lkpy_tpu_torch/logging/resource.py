"""Resource measurement of the host process (port of
``lkpy_tpu/logging/resource.py``; reference: src/lenskit/logging/_resource.py)."""

from __future__ import annotations

import resource

__all__ = ["max_memory", "reset_linux_hwm", "cpu_times"]


def max_memory() -> int:
    """Peak RSS in bytes (high-water mark)."""
    kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return kb * 1024


def reset_linux_hwm():
    """Reset the RSS high-water mark (Linux only; best effort)."""
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
    except OSError:
        pass


def cpu_times() -> tuple[float, float]:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime, ru.ru_stime
