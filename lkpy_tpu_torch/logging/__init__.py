"""
Structured logging, progress reporting and task tracking (port of
``lkpy_tpu/logging``; reference: src/lenskit/logging/): key-value loggers
(``get_logger``) and their set-up (``LoggingConfig``), TRACE-level tracing,
progress bars (Rich, or ipywidgets in a notebook), stopwatches, resource
and energy measurement, and hierarchical ``Task`` records;
:mod:`lkpy_tpu_torch.logging.multiprocess` relays worker processes' log
records to a monitor.
"""

from lkpy_tpu_torch.logging.logger import LKLogger, LoggingConfig, basic_logging, get_logger, notebook_logging
from lkpy_tpu_torch.logging.progress import Progress, item_progress, set_progress_impl
from lkpy_tpu_torch.logging.resource import max_memory, reset_linux_hwm
from lkpy_tpu_torch.logging.stopwatch import Stopwatch
from lkpy_tpu_torch.logging.tasks import Task
from lkpy_tpu_torch.logging.tracing import Tracer, activate_tracing, trace, tracing_active

__all__ = [
    "LKLogger",
    "LoggingConfig",
    "notebook_logging",
    "Progress",
    "Stopwatch",
    "Task",
    "Tracer",
    "activate_tracing",
    "basic_logging",
    "get_logger",
    "item_progress",
    "max_memory",
    "reset_linux_hwm",
    "set_progress_impl",
    "trace",
    "tracing_active",
]
