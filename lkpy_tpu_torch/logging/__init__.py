"""
Structured logging, progress reporting and task tracking (port of
``lkpy_tpu/logging``; reference: src/lenskit/logging/): key-value loggers
(``get_logger``) and their set-up (``LoggingConfig``), TRACE-level tracing,
progress bars (Rich, or ipywidgets in a notebook), stopwatches, resource
and energy measurement, and hierarchical ``Task`` records;
:mod:`lkpy_tpu_torch.logging.multiprocess` relays worker processes' log
records to a monitor.

The program's spans and counters (``lkt.*``; see
:mod:`lkpy_tpu_torch.logging.tracing`) time the ALS chunk loop and the
serving call's dispatch, readback and assembly.  They record while a
``torch.profiler`` session records, or inside ``record_spans()``::

    from lkpy_tpu_torch.logging import counts, record_spans, take_spans

    with record_spans():
        trainer.train_epoch()
    for s in take_spans():
        print(s.name, (s.end_ns - s.start_ns) / 1e3, "us")
    print(counts())  # als.entries_real, als.entries_padded

Under a profiler each span is also a ``record_function`` range of the same
name, so an exported trace shows them on the device's timeline.
"""

from lkpy_tpu_torch.logging.logger import LKLogger, LoggingConfig, basic_logging, get_logger, notebook_logging
from lkpy_tpu_torch.logging.progress import Progress, item_progress, set_progress_impl
from lkpy_tpu_torch.logging.resource import max_memory, reset_linux_hwm
from lkpy_tpu_torch.logging.stopwatch import Stopwatch
from lkpy_tpu_torch.logging.tasks import Task
from lkpy_tpu_torch.logging.tracing import (
    SpanRecord,
    Tracer,
    activate_tracing,
    count,
    counts,
    dropped_spans,
    record_spans,
    span,
    spans,
    take_spans,
    trace,
    tracing_active,
)

__all__ = [
    "LKLogger",
    "LoggingConfig",
    "notebook_logging",
    "Progress",
    "SpanRecord",
    "Stopwatch",
    "Task",
    "Tracer",
    "activate_tracing",
    "basic_logging",
    "count",
    "counts",
    "dropped_spans",
    "get_logger",
    "item_progress",
    "max_memory",
    "record_spans",
    "reset_linux_hwm",
    "set_progress_impl",
    "span",
    "spans",
    "take_spans",
    "trace",
    "tracing_active",
]
