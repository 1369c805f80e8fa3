"""
Per-stage pipeline profiling (port of ``lkpy_tpu/pipeline/profiling.py``).

Capability parity with the reference ``PipelineProfiler``
(reference: src/lenskit/pipeline/_profiling.py:45-80): one CSV row of
per-component wall-times per pipeline run, wired through
``Pipeline.run_all(_profile=...)`` and the batch runner; summaries via
``lkpy-tpu-torch profile summarize`` (reference: cli/profile/summarize.py).
"""

from __future__ import annotations

import csv
import gzip
import threading
from pathlib import Path
from typing import TextIO

import pandas as pd

__all__ = ["PipelineProfiler", "summarize_profile"]


class PipelineProfiler:
    """Collect per-component wall-times as CSV rows (one row per run).

    The times are the host's: a component that queues work on the card
    returns before the card finishes it, and the profiler does not wait.

    ``record`` is thread-safe: the thread-mode batch runner profiles runs
    from multiple worker threads concurrently.
    """

    def __init__(self, pipeline, file: Path | str):
        self.path = Path(file)
        stages = [n.name for n in pipeline.component_nodes()]
        self.stages = stages
        opener = gzip.open if self.path.suffix == ".gz" else open
        self.output: TextIO = opener(self.path, "wt")
        self.writer = csv.DictWriter(self.output, stages, extrasaction="ignore")
        self.writer.writeheader()
        self._lock = threading.Lock()

    def record(self, record: dict[str, float]):
        with self._lock:
            self.writer.writerow(record)

    def close(self):
        self.output.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def summarize_profile(file: Path | str) -> pd.DataFrame:
    """Summarize a profile CSV: mean/median/total seconds per stage
    (reference: cli/profile/summarize.py)."""
    df = pd.read_csv(file)
    out = pd.DataFrame(
        {
            "mean_ms": df.mean() * 1000,
            "median_ms": df.median() * 1000,
            "total_s": df.sum(),
            "runs": df.count(),
        }
    )
    out.index.name = "stage"
    return out
