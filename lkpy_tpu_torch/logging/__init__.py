"""
Key-value loggers, stopwatches, TRACE-level tracing and progress bars (port
of the parts of ``lkpy_tpu/logging`` that the pipeline and the batch runner
use; reference: src/lenskit/logging/).  The rest (logging set-up, resource
and power measurement, tasks) is not ported yet.
"""

from lkpy_tpu_torch.logging.logger import LKLogger, get_logger
from lkpy_tpu_torch.logging.progress import Progress, item_progress, set_progress_impl
from lkpy_tpu_torch.logging.stopwatch import Stopwatch
from lkpy_tpu_torch.logging.tracing import activate_tracing, trace, tracing_active

__all__ = [
    "LKLogger",
    "Progress",
    "Stopwatch",
    "activate_tracing",
    "get_logger",
    "item_progress",
    "set_progress_impl",
    "trace",
    "tracing_active",
]
