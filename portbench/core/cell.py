"""
One run of one cell, driven by data.

``BENCHMARK.json`` names the cell's configuration and traffic mix.  The
configuration is ``configs/<name>.json`` (its file in ``BENCHMARK.json``):
the model family, its settings, the data set's parameters, the controls'
precisions and the limits of the comparison.  The family is
``families/<family>.py`` (how the program's model is built and watched) with
its plain reference under ``reference/``.  The mix is
``traffic/<mix>.json``, whose ``loop`` names the general driver
``loops/<loop>.py`` that reads its parameters.  A per-layer metric is
``metrics/<metric>.py``, a reader with ``read(reading) -> float | None``.
Adding any of these adds files and entries; nothing here names them.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import resource
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench.core.trace import Trace, Tracer

__all__ = ["Cell", "Outcome", "Reading", "cell_metrics", "host_clocks", "load_benchmark", "load_reader", "run_cell", "sub_seed"]

ROOT = Path(__file__).resolve().parents[2]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _merge(base: dict, extra: dict | None) -> dict:
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``."""
    state = np.random.SeedSequence([seed % (1 << 64), tag]).generate_state(1, dtype=np.uint64)[0]
    return int(state & np.uint64((1 << 63) - 1))


def cell_metrics(bench: dict, workload: str) -> tuple[list, list]:
    """The cell's end-to-end and per-layer metric entries."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def load_reader(name: str, root: Path = ROOT):
    """The reader module ``metrics/<name>.py`` (names may hold dots)."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def host_clocks():
    """What the host did in the block, for the line before the result: the
    process's CPU seconds, its context switches (voluntary and not), the
    seconds the machine's hypervisor took from its CPUs (all of them), and
    the garbage collector's pauses (their sum, the longest, and the
    collections of each generation)."""
    out = {"gc_s": 0.0, "gc_max_s": 0.0, "gc_collections": [0, 0, 0]}
    began = []

    def clock(phase, info):
        if phase == "start":
            began.append(time.perf_counter())
        elif began:
            d = time.perf_counter() - began.pop()
            out["gc_s"] += d
            out["gc_max_s"] = max(out["gc_max_s"], d)
            out["gc_collections"][info["generation"]] += 1

    r0, c0, s0 = resource.getrusage(resource.RUSAGE_SELF), time.process_time(), _steal_s()
    gc.callbacks.append(clock)
    try:
        yield out
    finally:
        gc.callbacks.remove(clock)
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        out.update(cpu_s=time.process_time() - c0, switches=r1.ru_nvcsw - r0.ru_nvcsw, preempted=r1.ru_nivcsw - r0.ru_nivcsw)
        if s0 is not None:
            out["steal_s"] = _steal_s() - s0


def _steal_s() -> float | None:
    """The machine's CPU seconds stolen so far (``/proc/stat``), where it tells."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


@dataclass
class Cell:
    """What a loop needs: the cell's entries and the run's arguments."""

    cfg: dict
    mix: dict
    fam: object
    seed: int
    seconds: float
    device: torch.device
    tracer: Tracer
    setup: dict = field(default_factory=dict)  # seconds of each set-up part

    def gen(self, tag: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(sub_seed(self.seed, tag))
        return g

    def reset_peak(self) -> None:
        """Start the device's memory peak afresh once the inputs are made:
        what the benchmark drew them with is not the program's."""
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def part(self, name: str, t0: float) -> float:
        """Record a set-up part that began at ``t0`` (after a synchronize)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        self.setup[name] = self.setup.get(name, 0.0) + t - t0
        return t


@dataclass
class Outcome:
    """A loop's result: end-to-end values by metric name, the counts of the
    window, counters for the readers, the trace, and what the check needs
    (with no reference to the program's objects)."""

    values: dict
    attempted: int
    failed: int
    counters: dict
    trace: Trace | None
    check: dict


@dataclass
class Reading:
    """What a per-layer reader reads."""

    cfg: dict
    trace: Trace
    counters: dict


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: torch.device, *, t_start: float, root: Path = ROOT, overrides: dict | None = None, control: bool = False) -> dict:
    """Run the cell once and return its result (before printing)."""
    bench = load_benchmark(root)
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    over = overrides or {}
    cfg = _merge(json.loads((root / cfg_entry["file"]).read_text()), over.get("config"))
    mix = _merge(json.loads((root / "portbench" / "traffic" / f"{wl['traffic']}.json").read_text()), over.get("traffic"))
    fam = importlib.import_module(f"portbench.families.{cfg['family']}")
    loop = importlib.import_module(f"portbench.loops.{mix['loop']}")
    tracer = Tracer(trace)
    cell = Cell(cfg, mix, fam, seed, seconds, device, tracer)

    out: Outcome = loop.run(cell, t_start)
    setup_s = cell.setup.pop("total")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers, control_numbers = loop.check(cell, out.check, cfg["control"][mix["loop"]] if control else None)
    limits = {k: cfg["limits"][k] for k in numbers}
    correct = all(np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    result = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed, "numbers": numbers, "limits": limits}
    if control:
        result["control"] = control_numbers

    e2e, layer = cell_metrics(bench, workload)
    if trace:
        reading = Reading(cfg, out.trace, out.counters)
        metrics = {}
        for m in layer:
            value = load_reader(m["name"], root).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": out.trace.top_ops(10), "idle_gaps": out.trace.idle_gaps(10)}
        result["trace"] = {"busy_s": out.trace.busy_s(), "window_s": out.trace.window_s}
    else:
        values = dict(out.values, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    result["metrics"] = metrics
    result["memory_peak_bytes"] = int(peak)
    result["setup"] = dict(cell.setup, total=setup_s)
    result["host"] = out.counters.get("host")
    result["data"] = out.counters.get("data")
    return result
