"""
Hierarchical task tracking (port of ``lkpy_tpu/logging/tasks.py``;
reference: src/lenskit/logging/tasks.py:91).

Tasks record durations, CPU time, and peak memory for labeled spans of work,
with nesting; they serialize to JSON for offline analysis.
"""

from __future__ import annotations

import json
import time
import uuid
from contextvars import ContextVar
from pathlib import Path
from typing import Any

from pydantic import BaseModel, Field

from lkpy_tpu_torch.logging.resource import cpu_times, max_memory

__all__ = ["Task"]

_current_task: ContextVar["Task | None"] = ContextVar("lkpy_tpu_torch_task", default=None)


class Task(BaseModel):
    """A measured unit of work, possibly with subtasks."""

    task_id: str = Field(default_factory=lambda: str(uuid.uuid4()))
    label: str = "task"
    start_time: float | None = None
    finish_time: float | None = None
    duration: float | None = None
    cpu_time: float | None = None
    peak_memory: int | None = None
    system_power: float | None = None
    "Estimated total system energy over the task (Joules)."
    cpu_power: float | None = None
    "Estimated CPU energy over the task (Joules)."
    tpu_power: float | None = None
    "Estimated TPU/accelerator energy over the task (Joules)."
    status: str = "pending"
    subtasks: list["Task"] = Field(default_factory=list)

    _save_file: Path | None = None
    _cpu0: tuple[float, float] | None = None
    _energy0: Any = None
    _token: Any = None

    model_config = {"arbitrary_types_allowed": True}

    def __init__(self, label: str = "task", *, file: Path | str | None = None, **data):
        super().__init__(label=label, **data)
        if file is not None:
            self._save_file = Path(file)

    @classmethod
    def current(cls) -> "Task | None":
        return _current_task.get()

    def start(self):
        from lkpy_tpu_torch.logging.power import EnergySnapshot

        self.start_time = time.time()
        self._cpu0 = cpu_times()
        self._energy0 = EnergySnapshot()
        self.status = "running"
        parent = _current_task.get()
        if parent is not None and parent is not self:
            parent.subtasks.append(self)
        self._token = _current_task.set(self)

    def finish(self, status: str = "finished"):
        self.finish_time = time.time()
        self.duration = self.finish_time - (self.start_time or self.finish_time)
        if self._cpu0:
            u, s = cpu_times()
            self.cpu_time = (u - self._cpu0[0]) + (s - self._cpu0[1])
        self.peak_memory = max_memory()
        self._measure_energy()
        self.status = status
        if self._token is not None:
            _current_task.reset(self._token)
            self._token = None
        if self._save_file:
            self.save(self._save_file)

    def _measure_energy(self):
        """Record per-scope energy (reference: tasks.py:399-401): cumulative
        counters (registered meter / RAPL) preferred, Prometheus rate queries
        as fallback; all best-effort."""
        from lkpy_tpu_torch.logging.power import EnergySnapshot, measure_energy

        fields = {"system": "system_power", "cpu": "cpu_power", "tpu": "tpu_power"}
        deltas = EnergySnapshot().delta(self._energy0) if self._energy0 is not None else {}
        for scope, field in fields.items():
            if scope in deltas:
                setattr(self, field, deltas[scope])
            elif self.duration:
                setattr(self, field, measure_energy(scope, self.duration))

    def save(self, path: Path | str):
        Path(path).write_text(self.model_dump_json(indent=2))

    @classmethod
    def load(cls, path: Path | str) -> "Task":
        return cls.model_validate_json(Path(path).read_text())

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.finish("failed" if exc_type else "finished")
        return False
